"""Where does the flash chunk body spend its time on the card, and which
layout of rays and triangles over threads pays?

Counterpart of ``tools/flash3_probe.py`` (its kernel ``build`` :54-99 and
its ``pallas_call`` :109-117): the closest ``t`` per ray over ``NCHUNK =
50`` chunks x 128 random triangles of 17 plane rows (``_chunk_math``
:33-51), ``REPS = 8`` times, for ``R = 512`` rays; the result is the sum
over REPS of each ray's closest ``t``. The tool's four modes (``MODES``)
were layouts of the TPU's vector tiles; here each is the layout question
it stands for (``csrc/probe_flash_body.cu`` says how): ``base`` (one
thread per ray, planes read per test, a sequential chunk scan),
``hoist`` (ray terms held once per thread), ``both`` (each chunk's planes
staged in shared memory per block) and ``r8`` (four lanes per ray, eight
rays per warp, a warp-shuffle min); a fifth layout, ``tile``, is this
card's own: four rays per warp in every lane's registers, the 32 lanes
over each chunk's triangles, the chunks staged in shared memory with
``cp.async``, each rep's partial minimums merged by warp shuffles
(``flash_body_tile_twin`` is its schedule on the host). Each runs at the
tool's 512 rays and, as ``<mode>_32k``, at 32,768 rays (the margin
kernel's camera-ray count in ``chip_smoke.py``). At 32,768 rays ``base``,
``hoist`` and ``both`` offer the 132 SMs about 8 warps each (of 64), ``r8``
31 and ``tile`` 62.

``flash_body`` launches the kernel for CUDA tensors and runs
``flash_body_plain`` for CPU tensors.

    python -m zraytrace_tpu_torch.probes.flash3_probe [--cpu] [variant ...]
"""

from __future__ import annotations

import ctypes
import sys

import numpy as np
import torch

from zraytrace_tpu_torch.probes import common

__all__ = ["MODES", "VARIANTS", "SHAPES", "LAUNCHES", "R", "R_FULL", "LANE", "NCHUNK", "REPS",
           "TILE_RAYS", "TILE_LANES", "flash_body", "flash_body_plain", "flash_body_tile_twin",
           "chunk_min", "make_inputs", "measure", "flash_ops", "rcp_check"]

R = 512
R_FULL = 32768
LANE = 128
NCHUNK = 50  # teapot scale
REPS = 8
N_ROWS = 17
MODES = ("base", "hoist", "both", "r8", "tile")
TILE_RAYS = 4  # tile: rays per warp, held by every lane
TILE_LANES = 32  # tile: lanes over each chunk's triangles
# variant -> (mode, rays)
SHAPES = {m: (m, R) for m in MODES}
SHAPES.update({f"{m}_32k": (m, R_FULL) for m in MODES})
VARIANTS = tuple(SHAPES)

# Kernel launches made by ``flash_body`` in this process.
LAUNCHES = 0

BIG = 3.4e38
_RAY_BLOCK = 4096  # rays per step of the plain version


def chunk_min(ray, planes):
    """The closest valid t of each ray over every triangle (the tool's
    _chunk_math, its ``t < t_best`` filter dropped: it removes no minimum).
    ``ray``: six ``(n,)`` tensors ox .. dz; ``planes``: the first 17 rows
    of ``(17+, ...)`` plane rows are read."""
    ox, oy, oz, dx, dy, dz = (v[:, None] for v in ray)
    pxv = oy * dz - oz * dy
    pyv = oz * dx - ox * dz
    pzv = ox * dy - oy * dx
    (e1x, e1y, e1z, e2x, e2y, e2z, fnx, fny, fnz, qax, qay, qaz, rax, ray_, raz, adf,
     valid) = (planes[k].reshape(1, -1) for k in range(N_ROWS))
    det = -(dx * fnx + dy * fny + dz * fnz)
    safe = det.abs() > 1e-12
    inv_det = 1.0 / torch.where(safe, det, 1.0)
    u = (pxv * e2x + pyv * e2y + pzv * e2z - (dx * qax + dy * qay + dz * qaz)) * inv_det
    v = -(pxv * e1x + pyv * e1y + pzv * e1z - (dx * rax + dy * ray_ + dz * raz)) * inv_det
    t = (ox * fnx + oy * fny + oz * fnz - adf) * inv_det
    is_hit = ((det >= 1e-6) & (t > 1e-3) & (t < BIG) & (u >= 0.0) & (v >= 0.0)
              & (u + v <= 1.0) & (valid > 0.5))
    return torch.where(is_hit, t, BIG).amin(dim=1)


def flash_body_plain(planes: torch.Tensor, o: torch.Tensor, d: torch.Tensor,
                     reps: int = REPS) -> torch.Tensor:
    """Sum over ``reps`` of each ray's closest t, ``(R,)`` f32; planes
    ``(17, NCHUNK, 128)``, rays ``o``, ``d`` ``(R, 3)``."""
    acc = torch.zeros(o.shape[0], dtype=torch.float32, device=o.device)
    for _ in range(reps):
        best = torch.cat([chunk_min((o[s:s + _RAY_BLOCK].unbind(1)
                                      + d[s:s + _RAY_BLOCK].unbind(1)), planes)
                          for s in range(0, o.shape[0], _RAY_BLOCK)])
        acc = acc + best
    return acc


def flash_body_tile_twin(planes: torch.Tensor, o: torch.Tensor, d: torch.Tensor,
                         reps: int = REPS) -> torch.Tensor:
    """``tile``'s schedule on the host: the rays padded to whole warps of
    ``TILE_RAYS`` with copies of the last one; per rep each lane's partial
    minimum over its triangles (lane ``l`` tests ``l, l + 32, ...`` of
    every chunk) from the rep's start (0 once the sum is negative, which
    it never is, else BIG), the lanes' partials merged, then added to the
    sum. Equal to ``flash_body_plain`` bit for bit, as a minimum is exact
    in any order; the tests hold it so."""
    n = o.shape[0]
    rows = torch.arange(-(-n // TILE_RAYS) * TILE_RAYS, device=o.device).clamp(max=n - 1)
    ray = (*o[rows].unbind(1), *d[rows].unbind(1))
    acc = torch.zeros(rows.shape[0], dtype=torch.float32, device=o.device)
    for _ in range(reps):
        start = torch.where(acc < 0.0, 0.0, BIG)
        parts = [torch.minimum(start, chunk_min(ray, planes[:, :, lane::TILE_LANES]))
                 for lane in range(TILE_LANES)]
        acc = acc + torch.stack(parts).amin(dim=0)
    return acc[:n]


def flash_body(mode: str, planes: torch.Tensor, o: torch.Tensor, d: torch.Tensor,
               reps: int = REPS) -> torch.Tensor:
    """One launch of the probe kernel in layout ``mode`` on CUDA tensors;
    the plain version on CPU tensors."""
    global LAUNCHES
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    if (planes.dim() != 3 or planes.shape[0] != N_ROWS or planes.shape[2] != LANE
            or o.shape != d.shape or o.dim() != 2 or o.shape[1] != 3
            or any(t.dtype != torch.float32 for t in (planes, o, d))):
        raise ValueError("planes must be (17, C, 128) and o, d (R, 3), all float32")
    if o.device.type == "cpu":
        return flash_body_plain(planes, o, d, reps)
    if o.device.type != "cuda" or planes.device != o.device or d.device != o.device:
        raise ValueError("flash_body runs on cpu or cuda tensors, all on one device")
    planes, o, d = planes.contiguous(), o.contiguous(), d.contiguous()
    if planes.data_ptr() % 16:  # tile stages 16-byte rows with cp.async
        planes = planes.clone()
    out = torch.empty(o.shape[0], dtype=torch.float32, device=o.device)
    _P, _I = ctypes.c_void_p, ctypes.c_int
    fn = common.bind("probe_flash_body", "zr_probe_flash_body_launch",
                     [_I, _P, _I, _P, _P, _P, _I, _I, _P])
    with torch.cuda.device(o.device):
        common.launch("probe_flash_body", fn, MODES.index(mode), planes.data_ptr(),
                      planes.shape[1], o.data_ptr(), d.data_ptr(), out.data_ptr(), o.shape[0],
                      reps)
    LAUNCHES += 1
    return out


def rcp_check(device) -> tuple[int, int]:
    """(floats on the fast path, of those the ones that differ): the
    tile and cull kernels' branch-free reciprocal (``rcp_rn_fast`` in
    ``csrc/flash_chunk.cuh``) against CUDA's correctly rounded
    ``__frcp_rn`` on every one of the 2^32 float bit patterns, on the
    card."""
    if torch.device(device).type != "cuda":
        raise ValueError("rcp_check runs on a CUDA device")
    tally = torch.zeros(2, dtype=torch.int64, device=device)
    fn = common.bind("probe_flash_body", "zr_probe_rcp_check",
                     [ctypes.c_uint, ctypes.c_uint, ctypes.c_void_p, ctypes.c_void_p])
    with torch.cuda.device(device):
        for lo in (0, 1 << 31):
            common.launch("probe_flash_body", fn, lo, 1 << 31, tally.data_ptr())
    return tuple(tally.tolist())


def make_inputs(device, rays: int = R, nchunk: int = NCHUNK, seed: int = 0):
    """(planes, o, d) as the tool draws them: planes uniform in [0, 1),
    origins in [-2, 2)^3, unit directions."""
    rng = np.random.default_rng(seed)
    planes = rng.random((N_ROWS, nchunk, LANE)).astype(np.float32)
    o = (rng.random((rays, 3)) * 4 - 2).astype(np.float32)
    d0 = rng.standard_normal((rays, 3))
    d = (d0 / np.linalg.norm(d0, axis=1, keepdims=True)).astype(np.float32)
    return tuple(torch.from_numpy(a).to(device) for a in (planes, o, d))


# FP32 operations, counted from csrc/probe_flash_body.cu: per ray-triangle
# pair det 6, 1/det 1, u 12, v 13, t 7, u + v 1; per ray and rep o x d 9
# and the sum 1.
PAIR_FLOPS = 40
RAY_REP_FLOPS = 10


def flash_ops(rays: int, nchunk: int = NCHUNK, reps: int = REPS) -> int:
    return reps * (rays * nchunk * LANE * PAIR_FLOPS + rays * RAY_REP_FLOPS)


def measure(device, variants=VARIANTS) -> list[dict]:
    """One row per variant (see ``probes.common``): every layout's sums
    equal the plain version's bit for bit (each t in the same operation
    order; a minimum is exact); ps per ray-triangle pair as the tool
    printed it. The plain version runs once per ray count; the kernels are
    timed as CUDA graphs of launches."""
    rows, plain_runs = [], {}
    for name in variants:
        mode, rays = SHAPES[name]
        planes, o, d = make_inputs(device, rays)
        if rays not in plain_runs:
            plain_runs[rays] = common.time_ms(lambda: flash_body_plain(planes, o, d), device,
                                              repeats=1)
        plain, plain_ms = plain_runs[rays]
        row = dict(probe="flash3_probe", variant=name, device=str(device), plain_ms=plain_ms,
                   ms=None, per=None, unit="ps/pair", max_abs_err=None)
        if device.type == "cuda":
            got = flash_body(mode, planes, o, d)
            row["max_abs_err"] = common.compare(f"flash3_probe {name}", got, plain)
            row["ms"] = common.time_graph(lambda: flash_body(mode, planes, o, d), device,
                                          launches=5)
            row["per"] = row["ms"] / (REPS * rays * NCHUNK * LANE) * 1e9
        rows.append(row)
    return rows


if __name__ == "__main__":
    sys.exit(common.main_for(measure, VARIANTS, sys.argv[1:]))
