"""What does a texel fetch cost inside a kernel on the card, against
PyTorch's library gather?

Counterpart of ``tools/inkernel_texel_probe.py`` (its kernel wrapper
``_pallas`` :82-91 and the probes built on it, :103-203), at the tool's
shapes:

- ``wide_dg1_W`` (W in 1k, 8k, 64k, 512k): an ``(8, W)`` f32 table
  gathered by ``(8, 512)`` ids, ``K = 32`` rounds with the ids rotated;
- ``blk_dg1_W`` (W in 1k, 8k): ``(64, W)`` by ``(64, 128)``;
- ``row1_dg1``: the ``(1, 2^19)`` table by ``(1, 8192)`` ids;
- ``reshape_rt``: the ``(acc + x) * 1.0000001`` chain of the relayout
  round trip (the relayout moves no data here);
- ``e2e_atlas``: ``(64, 128)`` flat ids into a ``(1, 2^19)`` packed u32
  atlas, unpacked to 3 f32 channels and summed over K rounds, held to
  numpy at ``rtol = 1e-6`` as the tool did; ``e2e_atlas_1m`` is the same
  at ``(8192, 128)`` lanes, the bounce kernel's lane count at 1000x1000;
- ``library_gather``: the library row, in place of the tool's XLA row
  gather: one PyTorch call ``atlas[ids]`` on the ``(2^19, 3)`` f32 atlas
  for the same K x 8,192 texels (timed only, on the card); the
  ``e2e_atlas_1m`` row carries the same call's time at its 1M lanes.

The kernel and its note (what bounds it, why the atlas is not staged in
shared memory, e2e_atlas's lanes over rounds and channel table) are
``csrc/probe_texel.cu``. ``texel_gather`` launches it for CUDA tensors
and runs ``texel_gather_plain`` for CPU tensors.

    python -m zraytrace_tpu_torch.probes.inkernel_texel_probe [--cpu] [variant ...]
"""

from __future__ import annotations

import ctypes
import sys

import numpy as np
import torch

from zraytrace_tpu_torch import vecmath as vm
from zraytrace_tpu_torch.probes import common

__all__ = ["VARIANTS", "SHAPES", "LAUNCHES", "K", "F_ATLAS", "texel_gather",
           "texel_gather_plain", "channel_table", "make_inputs", "numpy_e2e", "library_gather",
           "measure", "e2e_ops"]

L = 128
K = 32  # rounds per launch, the ids rotated by the round
F_ATLAS = 1 << 19  # texels of the packed atlas (the 7-spheres atlas scale)
MODES = ("dg1", "reshape_rt", "e2e_atlas")

# variant -> (mode, rows, table width, columns)
SHAPES = {f"wide_dg1_{w}": ("dg1", 8, w, 512) for w in (1024, 8192, 65536, 524288)}
SHAPES.update({f"blk_dg1_{w}": ("dg1", 64, w, 128) for w in (1024, 8192)})
SHAPES.update(row1_dg1=("dg1", 1, F_ATLAS, 8192), reshape_rt=("reshape_rt", 64, 0, L),
              e2e_atlas=("e2e_atlas", 64, F_ATLAS, L),
              e2e_atlas_1m=("e2e_atlas", 8192, F_ATLAS, L))
VARIANTS = tuple(SHAPES) + ("library_gather",)

# Kernel launches made by ``texel_gather`` in this process.
LAUNCHES = 0

_CHANNEL_TABLES: dict = {}


def channel_table(device) -> torch.Tensor:
    """``(256,)`` f32: ``c / 255`` for each channel value c, divided as the
    plain version divides (``vm.div``, correctly rounded), so a lookup is
    bit-equal to the division. Made once per device; the e2e_atlas kernel
    reads it in place of its three divisions per texel."""
    device = torch.device(device)
    if device not in _CHANNEL_TABLES:
        _CHANNEL_TABLES[device] = vm.div(torch.arange(256, dtype=torch.float32, device=device),
                                         255.0)
    return _CHANNEL_TABLES[device]


def texel_gather_plain(mode: str, table: torch.Tensor, idx: torch.Tensor | None,
                       rounds: int = K) -> torch.Tensor:
    """The probe's function in plain PyTorch. ``dg1``: ``(R, NI)`` sums of
    ``table[r, (idx + i) & (W - 1)]``; ``reshape_rt``: the chain on
    ``table`` (the ``x`` plane); ``e2e_atlas``: ``(3, R, L)`` channel sums
    from the ``(F,)`` int32 atlas ``table``."""
    if mode == "dg1":
        acc = torch.zeros(idx.shape, dtype=torch.float32, device=table.device)
        for i in range(rounds):
            acc = acc + torch.gather(table, 1, ((idx + i) & (table.shape[1] - 1)).long())
        return acc
    if mode == "reshape_rt":
        f = torch.full((), 1.0000001, dtype=torch.float32, device=table.device)
        acc = torch.zeros_like(table)
        for _ in range(rounds):
            acc = (acc + table) * f
        return acc
    acc = torch.zeros((3,) + tuple(idx.shape), dtype=torch.float32, device=table.device)
    for i in range(rounds):
        got = table[((idx + i) & (table.shape[0] - 1)).long()]
        for c, shift in enumerate((16, 8, 0)):
            acc[c] = acc[c] + vm.div(((got >> shift) & 255).to(torch.float32), 255.0)
    return acc


def texel_gather(mode: str, table: torch.Tensor, idx: torch.Tensor | None,
                 rounds: int = K) -> torch.Tensor:
    """One launch of the probe kernel on CUDA tensors; the plain version
    on CPU tensors."""
    global LAUNCHES
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    want = torch.int32 if mode == "e2e_atlas" else torch.float32
    if table.dtype != want or (idx is not None and idx.dtype != torch.int32):
        raise ValueError(f"{mode}: table must be {want} and idx int32")
    if mode == "reshape_rt":
        rows, width, cols = table.shape[0], 0, table.shape[1]
    else:
        width = table.shape[-1]
        rows, cols = idx.shape
        if width & (width - 1) or (mode == "dg1" and table.shape[0] != rows):
            raise ValueError(f"{mode}: the table's width must be a power of two and its rows "
                             "those of idx")
    if table.device.type == "cpu":
        return texel_gather_plain(mode, table, idx, rounds)
    if table.device.type != "cuda" or (idx is not None and idx.device != table.device):
        raise ValueError("texel_gather runs on cpu or cuda tensors, all on one device")
    table = table.contiguous()
    idx = None if idx is None else idx.contiguous()
    shape = (3, rows, cols) if mode == "e2e_atlas" else (rows, cols)
    out = torch.empty(shape, dtype=torch.float32, device=table.device)
    _P, _I = ctypes.c_void_p, ctypes.c_int
    chan = channel_table(table.device).data_ptr() if mode == "e2e_atlas" else None
    fn = common.bind("probe_texel", "zr_probe_texel_launch",
                     [_I, _P, _P, _P, _P, _I, _I, _I, _I, _P])
    with torch.cuda.device(table.device):
        common.launch("probe_texel", fn, MODES.index(mode), table.data_ptr(),
                      None if idx is None else idx.data_ptr(), chan, out.data_ptr(), rows,
                      width, cols, rounds)
    LAUNCHES += 1
    return out


def make_inputs(variant: str, device, seed: int = 0):
    """(mode, table, idx) of a variant, drawn as the tool draws them."""
    mode, rows, width, cols = SHAPES[variant]
    rng = np.random.default_rng(seed)
    if mode == "dg1":
        table = rng.random((rows, width)).astype(np.float32)
        idx = rng.integers(0, width, (rows, cols)).astype(np.int32)
    elif mode == "reshape_rt":
        return mode, torch.from_numpy(rng.random((rows, cols)).astype(np.float32)).to(device), None
    else:
        table = rng.integers(0, 1 << 24, (1, width)).astype(np.int32)[0]
        idx = rng.integers(0, width, (rows, cols)).astype(np.int32)
    return mode, torch.from_numpy(table).to(device), torch.from_numpy(idx).to(device)


def numpy_e2e(table: np.ndarray, idx: np.ndarray, rounds: int = K) -> np.ndarray:
    """The tool's numpy replay of e2e_atlas (:191-197)."""
    ref = np.zeros((3,) + idx.shape, np.float32)
    for i in range(rounds):
        got = table[(idx + i) & (table.shape[0] - 1)]
        ref[0] += ((got >> 16) & 255).astype(np.float32) / 255.0
        ref[1] += ((got >> 8) & 255).astype(np.float32) / 255.0
        ref[2] += (got & 255).astype(np.float32) / 255.0
    return ref


def library_gather(atlas_rgb: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """The library row: one PyTorch call gathering the rows ``ids`` of an
    ``(F, 3)`` f32 atlas (timed beside the kernel; the port never calls it)."""
    return atlas_rgb[ids]


def e2e_ops(n_texels: int) -> tuple[int, int]:
    """(FP32, int32) operations of e2e_atlas for ``n_texels`` fetches, from
    csrc/probe_texel.cu: per fetch three adds (FP32; the channel values are
    looked up, not divided), and the rotation's add and mask and the
    unpacking's three shifts and three masks (int32)."""
    return 3 * n_texels, 8 * n_texels


def measure(device, variants=VARIANTS) -> list[dict]:
    """One row per variant (see ``probes.common``): kernel against plain
    bit for bit (separately rounded adds, multiplies and divisions), and
    e2e_atlas against numpy at rtol 1e-6; the kernel timed as a CUDA graph
    of launches. The e2e_atlas rows carry ``library_ms``, the library
    gather's time for the same texels."""
    rows = []
    for name in variants:
        if name == "library_gather":
            continue  # timed with e2e_atlas, below
        mode, table, idx = make_inputs(name, device)
        n = table.numel() if idx is None else idx.numel()
        plain, plain_ms = common.time_ms(lambda: texel_gather_plain(mode, table, idx), device,
                                         repeats=1)
        if mode == "e2e_atlas":
            want = numpy_e2e(table.cpu().numpy(), idx.cpu().numpy())
            np.testing.assert_allclose(plain.cpu().numpy(), want, rtol=1e-6)
        unit = "ns/texel" if mode == "e2e_atlas" else "ns/element"
        row = dict(probe="inkernel_texel_probe", variant=name, device=str(device),
                   plain_ms=plain_ms, ms=None, per=None, unit=unit, max_abs_err=None)
        if device.type == "cuda":
            got = texel_gather(mode, table, idx)
            row["max_abs_err"] = common.compare(f"inkernel_texel_probe {name}", got, plain)
            if mode == "e2e_atlas":
                np.testing.assert_allclose(got.cpu().numpy(), want, rtol=1e-6)
            row["ms"] = common.time_graph(lambda: texel_gather(mode, table, idx), device)
            row["per"] = row["ms"] / (K * n) * 1e6
            if mode == "e2e_atlas":
                rgb = torch.stack([((table >> s) & 255).to(torch.float32) / 255.0
                                   for s in (16, 8, 0)], dim=1)
                ids = ((idx.reshape(1, -1) + torch.arange(K, device=device)[:, None])
                       & (table.shape[0] - 1)).long()
                row["library_ms"] = common.time_graph(lambda: library_gather(rgb, ids), device)
                row["touched_texels"] = int(torch.unique(ids).numel())
                if name == "e2e_atlas":
                    rows.append(dict(probe="inkernel_texel_probe", variant="library_gather",
                                     device=str(device), plain_ms=None, ms=row["library_ms"],
                                     per=row["library_ms"] / ids.numel() * 1e6,
                                     unit="ns/texel", max_abs_err=None))
                del rgb, ids
        rows.append(row)
    return rows


if __name__ == "__main__":
    sys.exit(common.main_for(measure, VARIANTS, sys.argv[1:]))
