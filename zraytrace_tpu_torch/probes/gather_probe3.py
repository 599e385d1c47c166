"""What do the gathers and rotations of a texture fetch cost inside a
kernel on the card, and how much on-chip scratch can a block hold?

Counterpart of ``tools/gather_probe3.py`` (its ``pallas_call``\\ s :63,
:166 and :229), ``L = 128`` lanes, ``K = 32`` rounds per launch:

- ``dg0_1024``, ``dg0_4096``: ``sum_K tbl[(idx + i) & (R - 1), l]`` on an
  ``(R, 128)`` f32 table (take_along_axis on axis 0);
- ``dg1_1024``: ``sum_K tbl[r, (idx + i) & 127]`` (axis 1);
- ``roll_1024``, ``roll_dyn_1024``: ``sum_K roll(x, s, axis=1)`` with
  ``s = 1`` or ``s = i``, in ``jnp.roll``'s direction;
- ``tex128_1024``: ``tbl[q, c]`` on an int32 ``(1024, 128)`` table, the
  tool's contract (its 128-round rotate-gather is TPU machinery; the
  kernel gathers directly);
- ``xla_gather``: the library row, ``sum_K tbl[(idx + i) % F][:, 0]`` on
  ``F = 533,000`` rows of 3 f32 and 131,072 lanes, through PyTorch
  indexing (the tool ran it in XLA, outside Pallas);
- ``vmem_48k``, ``vmem_100k``, ``vmem_optin``: a block with that many bytes
  of dynamic shared memory writes rows 0 and n - 1 of its scratch and
  returns their sum (3.0 per lane); ``vmem_refused``: a request of the
  card's opt-in limit plus 1 KB must be refused, and the probe reports the
  limit as its measured cap. The TPU's VMEM megabytes have no counterpart.

Rows of the gathers, rolls and tex128 carry ``library_ms``: one PyTorch
call for the same reads (``torch.gather`` of all K rounds' ids,
``tbl[q, c]``), or K calls of ``torch.roll`` for a roll launch. The
kernels and what bounds them: ``csrc/probe_gather3.cu``. ``gather3`` and
``scratch`` launch them for CUDA tensors and run the plain versions for
CPU tensors.

    python -m zraytrace_tpu_torch.probes.gather_probe3 [--cpu] [variant ...]
"""

from __future__ import annotations

import ctypes
import sys

import numpy as np
import torch

from zraytrace_tpu_torch.probes import common

__all__ = ["MODES", "VARIANTS", "SHAPES", "LAUNCHES", "L", "K", "F_XLA", "gather3",
           "gather3_plain", "scratch", "scratch_plain", "scratch_refused", "smem_optin",
           "make_inputs", "library_xla_gather", "measure"]

L = 128
K = 32
F_XLA = 533000
XLA_LANES = 1024 * L
MODES = ("dg0", "dg1", "roll", "roll_dyn", "tex")
# variant -> (mode, rows)
SHAPES = {"dg0_1024": ("dg0", 1024), "dg0_4096": ("dg0", 4096), "dg1_1024": ("dg1", 1024),
          "roll_1024": ("roll", 1024), "roll_dyn_1024": ("roll_dyn", 1024),
          "tex128_1024": ("tex", 1024)}
# scratch variants -> bytes of dynamic shared memory (None: the card's limit)
SCRATCH = {"vmem_48k": 48 * 1024, "vmem_100k": 100 * 1024, "vmem_optin": None}
VARIANTS = tuple(SHAPES) + ("xla_gather",) + tuple(SCRATCH) + ("vmem_refused",)

# Kernel launches made by ``gather3`` and ``scratch`` in this process.
LAUNCHES = 0

_P, _I = ctypes.c_void_p, ctypes.c_int


def gather3_plain(mode: str, tbl: torch.Tensor, idx: torch.Tensor | None = None,
                  idx2: torch.Tensor | None = None, rounds: int = K) -> torch.Tensor:
    """The probe's function in plain PyTorch (see the module note); for
    ``tex`` ``idx`` is q and ``idx2`` is c."""
    rows = tbl.shape[0]
    if mode == "tex":
        return tbl[(idx & (rows - 1)).long(), (idx2 & (L - 1)).long()]
    acc = torch.zeros(tbl.shape, dtype=torch.float32, device=tbl.device)
    for i in range(rounds):
        if mode == "dg0":
            g = torch.gather(tbl, 0, ((idx + i) & (rows - 1)).long())
        elif mode == "dg1":
            g = torch.gather(tbl, 1, ((idx + i) & (L - 1)).long())
        else:
            g = torch.roll(tbl, i if mode == "roll_dyn" else 1, 1)
        acc = acc + g
    return acc


def _lib():
    """The gather entry (typed by ``common.bind``, with the error strings)
    and the library, its scratch entries typed."""
    from zraytrace_tpu_torch.ops.build import load

    fn = common.bind("probe_gather3", "zr_probe_gather3_launch", [_I, _P, _P, _P, _P, _I, _I, _P])
    lib = load("probe_gather3")
    if lib.zr_probe_scratch_launch.argtypes is None:
        lib.zr_probe_scratch_launch.argtypes = [_P, _P, _I, _P]
        lib.zr_probe_scratch_launch.restype = _I
        lib.zr_probe_smem_optin.argtypes = []
        lib.zr_probe_smem_optin.restype = _I
    return fn, lib


def gather3(mode: str, tbl: torch.Tensor, idx: torch.Tensor | None = None,
            idx2: torch.Tensor | None = None, rounds: int = K) -> torch.Tensor:
    """One launch of the probe kernel in ``mode`` on CUDA tensors; the plain
    version on CPU tensors. ``tbl`` ``(R, 128)`` (f32, int32 for ``tex``),
    R a power of two; ids int32 of the same shape."""
    global LAUNCHES
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    rows = tbl.shape[0]
    want = torch.int32 if mode == "tex" else torch.float32
    ids = [x for x in (idx, idx2) if x is not None]
    n_ids = {"dg0": 1, "dg1": 1, "roll": 0, "roll_dyn": 0, "tex": 2}[mode]
    if (tbl.dim() != 2 or tbl.shape[1] != L or rows & (rows - 1) or tbl.dtype != want
            or len(ids) != n_ids or any(x.shape != tbl.shape or x.dtype != torch.int32
                                        for x in ids)):
        raise ValueError(f"{mode}: tbl must be ({rows}, 128) {want} with rows a power of two "
                         f"and {n_ids} int32 id arrays of its shape")
    if tbl.device.type == "cpu":
        return gather3_plain(mode, tbl, idx, idx2, rounds)
    if tbl.device.type != "cuda" or any(x.device != tbl.device for x in ids):
        raise ValueError("gather3 runs on cpu or cuda tensors, all on one device")
    tbl = tbl.contiguous()
    idx, idx2 = (None if x is None else x.contiguous() for x in (idx, idx2))
    out = torch.empty(tbl.shape, dtype=want, device=tbl.device)
    fn, _ = _lib()
    with torch.cuda.device(tbl.device):
        common.launch("probe_gather3", fn, MODES.index(mode), tbl.data_ptr(),
                      None if idx is None else idx.data_ptr(),
                      None if idx2 is None else idx2.data_ptr(), out.data_ptr(), rows, rounds)
    LAUNCHES += 1
    return out


def scratch_plain(x: torch.Tensor) -> torch.Tensor:
    """Row n - 1 (``2 x``) plus row 0 (``x``) of the scratch."""
    return x * 2.0 + x


def _check_scratch(x: torch.Tensor, nbytes: int) -> None:
    if x.shape != (L,) or x.dtype != torch.float32:
        raise ValueError("x must be (128,) float32")
    if nbytes < 2 * L * 4 or nbytes % (L * 4):
        raise ValueError("nbytes must be a multiple of 512, at least 1024")


def scratch(x: torch.Tensor, nbytes: int) -> torch.Tensor:
    """One launch of the scratch kernel with ``nbytes`` of dynamic shared
    memory on a CUDA ``x`` (raises if the card refuses the request); the
    plain version on a CPU ``x``."""
    global LAUNCHES
    _check_scratch(x, nbytes)
    if x.device.type == "cpu":
        return scratch_plain(x)
    if x.device.type != "cuda":
        raise ValueError("scratch runs on cpu or cuda tensors")
    out = torch.empty_like(x)
    _, lib = _lib()
    with torch.cuda.device(x.device):
        common.launch("probe_gather3", lib.zr_probe_scratch_launch, x.contiguous().data_ptr(),
                      out.data_ptr(), nbytes)
    LAUNCHES += 1
    return out


def scratch_refused(x: torch.Tensor, nbytes: int) -> str | None:
    """Ask the card for a block with ``nbytes`` of shared memory: the
    CUDA error that refused it, or None if the kernel ran."""
    global LAUNCHES
    _check_scratch(x, nbytes)
    if x.device.type != "cuda":
        raise ValueError("scratch_refused asks a CUDA device")
    out = torch.empty_like(x)
    _, lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.zr_probe_scratch_launch(x.contiguous().data_ptr(), out.data_ptr(), nbytes,
                                          torch.cuda.current_stream().cuda_stream)
    if err == 0:
        LAUNCHES += 1
        return None
    return lib.zr_error_string(err).decode()


def smem_optin(device) -> int:
    """The card's opt-in limit of shared memory per block, in bytes."""
    _, lib = _lib()
    with torch.cuda.device(device):
        got = lib.zr_probe_smem_optin()
    if got <= 0:
        raise RuntimeError(f"cudaDeviceGetAttribute failed: {lib.zr_error_string(-got).decode()}")
    return got


def make_inputs(variant: str, device, seed: int = 0):
    """(mode, tbl, idx, idx2) of a gather variant, drawn as the tool draws
    them (``default_rng(0)``: the table, then the ids)."""
    mode, rows = SHAPES[variant]
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(a).to(device)
    if mode == "tex":
        tbl = rng.integers(0, 1 << 24, (rows, L)).astype(np.int32)
        q = rng.integers(0, rows, (rows, L)).astype(np.int32)
        c = rng.integers(0, L, (rows, L)).astype(np.int32)
        return mode, t(tbl), t(q), t(c)
    tbl = rng.random((rows, L)).astype(np.float32)
    if mode in ("roll", "roll_dyn"):
        return mode, t(tbl), None, None
    hi = rows if mode == "dg0" else L
    return mode, t(tbl), t(rng.integers(0, hi, (rows, L)).astype(np.int32)), None


def library_xla_gather(tbl: torch.Tensor, idx: torch.Tensor, rounds: int = K) -> torch.Tensor:
    """The tool's XLA row gather through PyTorch indexing: ``sum_K
    tbl[(idx + i) % F][:, 0]`` (the port never calls it)."""
    acc = torch.zeros(idx.shape, dtype=torch.float32, device=idx.device)
    for i in range(rounds):
        acc = acc + tbl[(idx + i) % tbl.shape[0]][:, 0]
    return acc


def _library_ms(mode, tbl, idx, idx2, device) -> float:
    """The library yardstick for one launch's reads (see the module note)."""
    rows = tbl.shape[0]
    if mode == "tex":
        q, c = idx.long(), idx2.long()
        return common.time_graph(lambda: tbl[q, c], device)
    if mode in ("roll", "roll_dyn"):
        shifts = [i if mode == "roll_dyn" else 1 for i in range(K)]
        return common.time_graph(lambda: [torch.roll(tbl, s, 1) for s in shifts], device)
    ar = torch.arange(K, device=device, dtype=torch.int32)[:, None, None]
    ids = ((idx[None] + ar) & ((rows if mode == "dg0" else L) - 1)).long()
    src, axis = tbl[None].expand(K, rows, L), 1 if mode == "dg0" else 2
    return common.time_graph(lambda: torch.gather(src, axis, ids), device)


def measure(device, variants=VARIANTS) -> list[dict]:
    """One row per variant (see ``probes.common``): the kernel equals the
    plain version bit for bit (gathers and integer reads exactly, the sums
    in the same order), timed as a CUDA graph of launches, with the library
    yardstick beside it; ``xla_gather`` is a library row; the scratch rows
    hold the kernel to 3.0 per lane and the refusal row checks that the
    card refuses a block above its opt-in limit."""
    rows = []
    for name in variants:
        row = dict(probe="gather_probe3", variant=name, device=str(device), ms=None, per=None,
                   max_abs_err=None)
        if name in SHAPES:
            mode, tbl, idx, idx2 = make_inputs(name, device)
            plain, row["plain_ms"] = common.time_ms(
                lambda: gather3_plain(mode, tbl, idx, idx2), device, repeats=1)
            row["unit"] = "ns/fetch" if mode == "tex" else "ns/element-round"
            if device.type == "cuda":
                got = gather3(mode, tbl, idx, idx2)
                row["max_abs_err"] = common.compare(f"gather_probe3 {name}", got, plain)
                row["ms"] = common.time_graph(lambda: gather3(mode, tbl, idx, idx2), device)
                n = tbl.numel() * (1 if mode == "tex" else K)
                row["per"] = row["ms"] / n * 1e6
                row["library_ms"] = _library_ms(mode, tbl, idx, idx2, device)
        elif name == "xla_gather":
            rng = np.random.default_rng(0)
            tbl = torch.from_numpy(rng.random((F_XLA, 3)).astype(np.float32)).to(device)
            idx = torch.from_numpy(rng.integers(0, F_XLA, XLA_LANES).astype(np.int64)).to(device)
            _, ms = common.time_ms(lambda: library_xla_gather(tbl, idx), device, repeats=3)
            row.update(unit="ns/row", plain_ms=None if device.type == "cuda" else ms)
            if device.type == "cuda":
                row.update(ms=ms / K, per=ms / K / XLA_LANES * 1e6,
                           note=f"{K} rounds of {XLA_LANES} rows per call of {ms:.5f} ms")
        else:
            x = torch.ones(L, dtype=torch.float32, device=device)
            row.update(unit="KB scratch", plain_ms=common.time_ms(lambda: scratch_plain(x), device,
                                                                  repeats=1)[1])
            if device.type == "cuda" and name == "vmem_refused":
                cap = smem_optin(device)
                refused = scratch_refused(x, cap + 1024)
                if refused is None:
                    raise common.ProbeMismatch(
                        f"gather_probe3 vmem_refused: a block of {cap + 1024} B of shared memory "
                        f"(the opt-in limit {cap} B + 1 KB) was not refused")
                row.update(plain_ms=None, cap_bytes=cap,
                           note=f"a block of {cap + 1024} B of shared memory (opt-in limit + 1 KB) "
                                f"refused: {refused}; measured cap {cap} B")
            elif device.type == "cuda":
                nbytes = SCRATCH[name] or smem_optin(device)
                got = scratch(x, nbytes)
                row["max_abs_err"] = common.compare(f"gather_probe3 {name}", got,
                                                    torch.full_like(x, 3.0))
                _, row["ms"] = common.time_ms(lambda: scratch(x, nbytes), device)
                row.update(per=nbytes / 1024, note=f"{nbytes} B, 3.0 in every lane")
        rows.append(row)
    return rows


if __name__ == "__main__":
    sys.exit(common.main_for(measure, VARIANTS, sys.argv[1:]))
