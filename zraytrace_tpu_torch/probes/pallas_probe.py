"""Can a kernel on the card loop a run-time number of times, gather from
an on-chip table, make random bits and run the port's PCG4D?

Counterpart of ``tools/pallas_probe.py`` (its five ``pallas_call``\\ s,
:56, :75, :95, :113 and :134), at the tool's ``(64, 128)`` = 8,192 lanes
and, as ``<variant>_1m``, at ``(8192, 128)`` = 2^20 lanes, about the
bounce kernel's lanes for scene 1 at 1000x1000 (the inputs drawn the same
way):

- ``while_loop``: the sum of ``x`` over a loop of ``TRIPS = 10`` trips,
  the count a kernel argument (random ``x``, so the sum is tested);
- ``vmem_gather_1d``: ``tbl[idx]`` from a 4,096-f32 table staged in
  shared memory;
- ``vmem_gather_2d_reshape``: the same from a ``(32, 128)`` table indexed
  ``[idx >> 7][idx & 127]``;
- ``prng``: uint32 random bits from seed 7. The TPU's hardware generator
  has no counterpart on the card; the kernel runs Philox4x32-10 (Salmon
  et al., SC'11) with key ``(seed, 0)`` and counter ``(lane, 0, 0, 0)``
  and keeps the first word. The plain version is int64 arithmetic masked
  to 32 bits (torch has no uint32 multiply-high);
- ``pcg4d_parity``: ``uniform4(42, px, 3, 1, STREAM_SCATTER)[..., 0]`` for
  ``px = 0 .. 8191`` through the bounce kernel's PCG4D
  (``csrc/bounce_common.cuh``), equal to ``rng.uniform4`` bit for bit.

Each row carries ``floor_ms`` (a kernel that does nothing, with the
launch's grid and block, timed the same way) and its bound (``work``: the
inputs and output once; the sums at the FP32 rate; Philox's and PCG4D's
integer operations for the word kept, ``probes/bounds.py``). Graph timing
reuses the same inputs, so they are warm in L2 (8 MB at 2^20 lanes).

The kernels and what bounds them: ``csrc/probe_pallas.cu``.
``pallas_kernel`` launches them for CUDA tensors and runs
``pallas_kernel_plain`` for CPU tensors.

    python -m zraytrace_tpu_torch.probes.pallas_probe [--cpu] [variant ...]
"""

from __future__ import annotations

import ctypes
import sys

import numpy as np
import torch

from zraytrace_tpu_torch import rng as zrng
from zraytrace_tpu_torch.probes import common
from zraytrace_tpu_torch.probes.bounds import PCG4D_X_INT_OPS, PHILOX_X_INT_OPS, bound

__all__ = ["MODES", "VARIANTS", "SHAPES", "LAUNCHES", "R", "R_1M", "L", "TABLE", "TRIPS",
           "PRNG_SEED", "PCG_SEED", "pallas_kernel", "pallas_kernel_plain", "philox4x32",
           "make_inputs", "launch_floor", "work", "measure"]

R, L = 64, 128
R_1M = 8192  # rows of 128 lanes of the _1m variants
TABLE = 4096  # f32 entries of the gather tables
TABLE_W = 128  # the 2-D table's width
TRIPS = 10
PRNG_SEED = 7
PCG_SEED = 42
PCG_SAMPLE, PCG_BOUNCE = 3, 1
MODES = ("while", "gather1d", "gather2d", "philox", "pcg4d")
# variant (the tool's name, and the same at 2^20 lanes) -> (mode, rows of 128 lanes)
_TOOL = {"while_loop": "while", "vmem_gather_1d": "gather1d",
         "vmem_gather_2d_reshape": "gather2d", "prng": "philox", "pcg4d_parity": "pcg4d"}
SHAPES = {**{v: (m, R) for v, m in _TOOL.items()},
          **{f"{v}_1m": (m, R_1M) for v, m in _TOOL.items()}}
VARIANTS = tuple(SHAPES)

# Kernel launches made by ``pallas_kernel`` in this process.
LAUNCHES = 0

_MASK = 0xFFFFFFFF
# Philox4x32-10 (Salmon, Moraes, Dror, Shaw, SC'11): round multipliers and
# the Weyl sequence that bumps the key
PHILOX_M0, PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
PHILOX_W0, PHILOX_W1 = 0x9E3779B9, 0xBB67AE85


def _mulhilo(a: torch.Tensor, m: int):
    """(hi, lo) words of ``a * m`` for int64 ``a`` in [0, 2^32) and a
    32-bit ``m``, from 16-bit halves of ``a`` so nothing leaves int64."""
    lo16 = (a & 0xFFFF) * m
    mid = (a >> 16) * m + (lo16 >> 16)
    return mid >> 16, ((mid & 0xFFFF) << 16) | (lo16 & 0xFFFF)


def philox4x32(ctr: torch.Tensor, seed: int, rounds: int = 10):
    """Philox4x32 of counters ``(ctr, 0, 0, 0)`` (int64 in [0, 2^32)) with
    key ``(seed, 0)``: the four output words, int64 in [0, 2^32)."""
    c0, c1, c2, c3 = ctr & _MASK, torch.zeros_like(ctr), torch.zeros_like(ctr), torch.zeros_like(ctr)
    k0, k1 = seed & _MASK, 0
    for r in range(rounds):
        if r:
            k0, k1 = (k0 + PHILOX_W0) & _MASK, (k1 + PHILOX_W1) & _MASK
        hi0, lo0 = _mulhilo(c0, PHILOX_M0)
        hi1, lo1 = _mulhilo(c2, PHILOX_M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def pallas_kernel_plain(mode: str, x: torch.Tensor, idx: torch.Tensor | None = None,
                        param: int = 0) -> torch.Tensor:
    """The probe's function in plain PyTorch. ``while``: ``param`` trips
    of ``acc + x``; ``gather1d``/``gather2d``: the table ``x`` at ``idx &
    4095``; ``philox``: the first Philox4x32-10 word of counters ``x`` with
    seed ``param`` (int32 bits); ``pcg4d``: ``uniform4(param, x, 3, 1,
    STREAM_SCATTER)[..., 0]``."""
    if mode == "while":
        acc = torch.zeros_like(x)
        for _ in range(param):
            acc = acc + x
        return acc
    if mode in ("gather1d", "gather2d"):
        return x.reshape(-1)[(idx & (TABLE - 1)).long()]
    if mode == "philox":
        return common.as_int32_bits(philox4x32(x.to(torch.int64) & _MASK, param)[0])
    return zrng.uniform4(param, x, PCG_SAMPLE, PCG_BOUNCE, zrng.STREAM_SCATTER)[..., 0]


_P, _I = ctypes.c_void_p, ctypes.c_int


def pallas_kernel(mode: str, x: torch.Tensor, idx: torch.Tensor | None = None,
                  param: int = 0) -> torch.Tensor:
    """One launch of the probe kernel in ``mode`` on CUDA tensors; the plain
    version on CPU tensors. ``x``: f32 lanes (``while``), the f32 table
    (4,096 entries; the gathers, with int32 ``idx``) or int32 counters
    (``philox``, ``pcg4d``); a view that is not 16-byte aligned is
    copied."""
    global LAUNCHES
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    gather = mode in ("gather1d", "gather2d")
    want = torch.int32 if mode in ("philox", "pcg4d") else torch.float32
    if x.dtype != want:
        raise ValueError(f"{mode}: x must be {want}")
    if gather and (x.numel() != TABLE or idx is None or idx.dtype != torch.int32):
        raise ValueError(f"{mode}: the table must hold {TABLE} floats and idx be int32")
    if x.device.type == "cpu":
        return pallas_kernel_plain(mode, x, idx, param)
    if x.device.type != "cuda" or (idx is not None and idx.device != x.device):
        raise ValueError("pallas_kernel runs on cpu or cuda tensors, all on one device")
    lanes = idx if gather else x
    x, idx = common.aligned16(x), common.aligned16(idx)
    out_dtype = torch.int32 if mode == "philox" else torch.float32
    out = torch.empty(lanes.shape, dtype=out_dtype, device=x.device)
    fn = common.bind("probe_pallas", "zr_probe_pallas_launch", [_I, _P, _P, _P, _I, _I, _P])
    with torch.cuda.device(x.device):
        common.launch("probe_pallas", fn, MODES.index(mode), x.data_ptr(),
                      None if idx is None else idx.data_ptr(), out.data_ptr(), out.numel(),
                      int(param))
    LAUNCHES += 1
    return out


def launch_floor(mode: str, n: int, device) -> None:
    """One launch of a kernel that does nothing, with the grid and block
    of ``pallas_kernel(mode)`` on ``n`` lanes: the launch floor of a row."""
    fn = common.bind("probe_pallas", "zr_probe_pallas_floor", [_I, _I, _P])
    with torch.cuda.device(device):
        common.launch("probe_pallas", fn, MODES.index(mode), n)


def work(mode: str, n: int, param: int) -> dict:
    """What one launch on ``n`` lanes must do, for its bound: FP32
    ``flops`` (the loop's ``param`` adds; PCG4D's scale), ``nbytes`` (the
    lanes' input and output and the gathers' table, each once) and
    ``int_ops`` (Philox's and PCG4D's, for the word kept)."""
    if mode == "while":
        return dict(flops=n * param, nbytes=8 * n, int_ops=0)
    if mode in ("gather1d", "gather2d"):
        return dict(flops=0, nbytes=4 * TABLE + 8 * n, int_ops=0)
    if mode == "philox":
        return dict(flops=0, nbytes=8 * n, int_ops=n * PHILOX_X_INT_OPS)
    return dict(flops=n, nbytes=8 * n, int_ops=n * PCG4D_X_INT_OPS)


def make_inputs(variant: str, device, seed: int = 0):
    """(mode, x, idx, param) of a variant: the gathers' ids drawn as the
    tool draws them (``default_rng(0)``, its first draw), then the random
    table (the tool's was ``arange``) and ``x``; the counters are the lane
    index."""
    mode, rows = SHAPES[variant]
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(a).to(device)
    if mode == "while":
        return mode, t(rng.random((rows, L)).astype(np.float32)), None, TRIPS
    if mode in ("gather1d", "gather2d"):
        idx = rng.integers(0, TABLE, (rows, L)).astype(np.int32)
        tbl = rng.random(TABLE).astype(np.float32)
        if mode == "gather2d":
            tbl = tbl.reshape(TABLE // TABLE_W, TABLE_W)
        return mode, t(tbl), t(idx), 0
    lanes = np.arange(rows * L, dtype=np.int32).reshape(rows, L)
    return mode, t(lanes), None, PRNG_SEED if mode == "philox" else PCG_SEED


def measure(device, variants=VARIANTS) -> list[dict]:
    """One row per variant (see ``probes.common``): the kernel equals the
    plain version (integers and gathers exactly, the sum and PCG4D's floats
    bit for bit), timed as a CUDA graph of launches beside its launch
    floor, with its bound; ns per lane. The gathers' rows carry
    ``library_ms``: one PyTorch call ``tbl[idx]``."""
    rows = []
    for name in variants:
        mode, x, idx, param = make_inputs(name, device)
        n = (x if idx is None else idx).numel()
        plain, plain_ms = common.time_ms(lambda: pallas_kernel_plain(mode, x, idx, param), device,
                                         repeats=1)
        row = dict(probe="pallas_probe", variant=name, device=str(device), plain_ms=plain_ms,
                   ms=None, per=None, unit="ns/lane", max_abs_err=None)
        w = work(mode, n, param)
        row["bound_ms"], row["bound_by"] = bound(w["flops"], w["nbytes"], int_ops=w["int_ops"])
        if device.type == "cuda":
            got = pallas_kernel(mode, x, idx, param)
            row["max_abs_err"] = common.compare(f"pallas_probe {name}", got, plain)
            row["ms"] = common.time_graph(lambda: pallas_kernel(mode, x, idx, param), device)
            row["floor_ms"] = common.time_graph(lambda: launch_floor(mode, n, device), device)
            row["per"] = row["ms"] / n * 1e6
            if idx is not None:  # the library gather of the same lanes
                flat, ids = x.reshape(-1), idx.long()
                row["library_ms"] = common.time_graph(lambda: flat[ids], device)
        rows.append(row)
    return rows


if __name__ == "__main__":
    sys.exit(common.main_for(measure, VARIANTS, sys.argv[1:]))
