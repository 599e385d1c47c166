"""Does a product-shaped triangle test pay on the card, and does one
chunk-skip decision per block of rays beat the port's per-ray cull?

Counterpart of ``tools/flash2_probe.py``: its product kernels (the
``pallas_call``\\ s :53, :104 and :176) and its block-culled flash body
(``probe_cullwhen``, :341), at the tool's shapes.

The product (``csrc/probe_mm.cu``), ``R = 512`` rays, ``G = 1600``
triangles in ``NG = 4`` column blocks, ``REPS = 16``:

- ``mm``: ``sum_REPS (lhs (512, 16) @ rhs (16, 6400))[:, :128]``, every
  column computed each rep, plus a per-row checksum of all columns (the
  XOR of each product's bits rotated by the rep); ``mm128`` the same with
  ``K = 128``, in GFLOP/s;
- ``mm_elem``: the whole intersect block per rep (Moller's det, u, v, t
  from the four column blocks, the hit test, each ray's least t with the
  lowest triangle on ties, a strict ``<`` winner across reps with id
  ``lane + rep``), ``(512, 2)`` ``[t_best, i_best]``;
- ``library_mm``: ``torch.matmul(lhs, rhs)`` in f32 (TF32 off), one
  product, all 6,400 columns written (``mm`` writes 128 and a checksum);
  ``library_mm128`` the same with ``K = 128``; ``library_mm_tf32``:
  ``library_mm`` with TF32 allowed for that call alone, a precision the
  port does not use, with its max |diff| from f32. All three are timed
  only.

Each product is summed over ``k`` in a fixed order, every multiply and
add rounded separately, so kernel and plain version agree bit for bit.

The block cull (``csrc/probe_flash_cull.cu``): 65,536 rays in blocks of
``RB = 512`` on the port's teapot (scene 3: BVH order, packed planes,
``(18, 50, 128)`` planes and ``(50, 8)`` bounds). Per block the range of
its origins and directions, the tool's conservative slab reach of each
chunk from that range, and the flash body on every ray of a block that
reaches the chunk: each ray's closest t and each block's chunk visits.
The kernel splits each reached chunk's 128 triangles over a cluster of
``CULL_SHARES`` CTAs whose minima meet in distributed shared memory
(``flash_cull_split`` is its schedule on the host).
``cullwhen_into`` takes the tool's rays from random points in [-2, 2)^3 in
random directions, ``cullwhen_away`` the same moved by (0, 100, 0) and
aimed at +y, ``cullwhen_camera`` scene 3's camera rays at 256x256, one
sample, in blocks of 512 pixels (two rows), so that blocks reach some
chunks and not others (the tool's sets reach all or none).
``flash1_into``, ``flash1_away`` and ``flash1_camera`` time the port's
per-ray cull flash kernel (``ops/flash_intersect.flash_intersect_triangles``,
the tool's ``probe_flash1`` / ``probe_cull``) on the same rays, whose t
must equal the block cull's.

``mm``, ``mm_elem`` and ``flash_cull`` launch the kernels for CUDA tensors
and run the plain versions for CPU tensors.

    python -m zraytrace_tpu_torch.probes.flash2_probe [--cpu] [variant ...]
"""

from __future__ import annotations

import ctypes
import sys

import numpy as np
import torch

from zraytrace_tpu_torch.probes import common
from zraytrace_tpu_torch.probes.flash3_probe import chunk_min

__all__ = ["VARIANTS", "MM_VARIANTS", "CULL_VARIANTS", "LAUNCHES", "CULL_LAUNCHES", "R", "G",
           "NG", "K", "K128", "REPS", "RB", "N_RAYS", "TIE_CASES", "CULL_SHARES", "CULL_RAY_SETS",
           "mm", "mm_plain", "mm_elem", "mm_elem_plain", "mm_elem_keyed", "flash_cull",
           "flash_cull_plain", "flash_cull_split", "make_mm_inputs", "make_tie_inputs",
           "cull_planes", "cull_rays", "mm_flops", "mm_elem_flops", "cull_flops", "measure"]

R = 512
G = 1600
NG = 4
K = 16
K128 = 128
REPS = 16
RB = 512
N_RAYS = 1 << 16
CULL_SHARES = 8  # CTAs per ray block: each tests 16 triangles of every reached chunk
CAMERA_WIDTH = 256  # the camera set's image width: a block of 512 rays is two rows
OUT_COLS = 128
BIG = 3.4e38
MM_VARIANTS = ("mm", "mm128", "mm_elem", "library_mm", "library_mm128", "library_mm_tf32")
# tie-heavy inputs of mm_elem (``make_tie_inputs``)
TIE_CASES = ("dup_columns", "no_hit_rows", "all_equal")
CULL_RAY_SETS = ("into", "away", "camera")
CULL_VARIANTS = tuple(f"{k}_{w}" for k in ("cullwhen", "flash1") for w in CULL_RAY_SETS)
VARIANTS = MM_VARIANTS + CULL_VARIANTS

# Kernel launches made by ``mm`` and ``mm_elem`` in this process.
LAUNCHES = 0
# Kernel launches made by ``flash_cull`` in this process.
CULL_LAUNCHES = 0

_MASK = 0xFFFFFFFF
_P, _I = ctypes.c_void_p, ctypes.c_int
_RAY_BLOCK = 8 * RB  # rays per step of the plain cull


def _product(lhs: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """``lhs @ rhs`` summed over k in order, each multiply and add rounded
    separately (the kernels' order)."""
    p = lhs[:, 0:1] * rhs[0]
    for k in range(1, lhs.shape[1]):
        p = p + lhs[:, k:k + 1] * rhs[k]
    return p


def _xor_columns(x: torch.Tensor) -> torch.Tensor:
    """XOR over the columns of int64 ``x`` (order-free), by halving."""
    while x.shape[1] > 1:
        if x.shape[1] % 2:
            x = torch.cat([x[:, :1] ^ x[:, -1:], x[:, 1:-1]], dim=1)
        half = x.shape[1] // 2
        x = x[:, :half] ^ x[:, half:]
    return x[:, 0]


def mm_plain(lhs: torch.Tensor, rhs: torch.Tensor, reps: int = REPS):
    """(sum over reps of the product's first 128 columns, (n, 128) f32;
    the checksum, (n,) int32 bits: XOR over reps and columns of each
    product's bits rotated left by ``rep & 31``)."""
    p = _product(lhs, rhs)
    acc = torch.zeros((lhs.shape[0], OUT_COLS), dtype=torch.float32, device=lhs.device)
    for _ in range(reps):
        acc = acc + p[:, :OUT_COLS]
    bits = _xor_columns(p.view(torch.int32).to(torch.int64) & _MASK)
    chk = torch.zeros_like(bits)
    for rep in range(reps):
        s = rep & 31
        chk = chk ^ (((bits << s) | (bits >> (32 - s))) & _MASK)
    return acc, common.as_int32_bits(chk)


def _pair_test(lhs: torch.Tensor, rhs: torch.Tensor):
    """Each ray and triangle's ``t`` and hit test, ``(n, g)`` each: the
    product's four column blocks as det, un, vn, tn, ``1/det`` where
    ``|det| > 1e-12``."""
    g = rhs.shape[1] // 4
    p = _product(lhs, rhs)
    det, un, vn, tn = (p[:, b * g:(b + 1) * g] for b in range(4))
    inv = 1.0 / torch.where(det.abs() > 1e-12, det, 1.0)
    u, v, t = un * inv, vn * inv, tn * inv
    return t, (det >= 1e-6) & (t > 1e-3) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)


def mm_elem_plain(lhs: torch.Tensor, rhs: torch.Tensor, reps: int = REPS) -> torch.Tensor:
    """The tool's intersect block, ``(n, 2)`` f32 ``[t_best, i_best]``."""
    t, hit = _pair_test(lhs, rhs)
    g = t.shape[1]
    t = torch.where(hit, t, BIG)
    tc = t.amin(dim=1)
    ids = torch.arange(g, device=lhs.device)
    lane = torch.where(t == tc[:, None], ids, g).amin(dim=1)
    t_best = torch.full_like(tc, BIG)
    i_best = torch.zeros_like(lane)
    for rep in range(reps):
        better = tc < t_best
        t_best = torch.where(better, tc, t_best)
        i_best = torch.where(better, lane + rep, i_best)
    return torch.stack([t_best, i_best.to(torch.float32)], dim=-1)


_NO_KEY = (1 << 63) - 1  # above every key: the kernel's all-ones key


def mm_elem_keyed(lhs: torch.Tensor, rhs: torch.Tensor, reps: int = REPS) -> torch.Tensor:
    """The kernel's winner, on the host: every hit with t below 3.4e38 as
    the key ``(float bits of t) << 32 | rep << 16 | triangle``, the least
    key over triangles and reps (the kernel's atomicMin), decoded into
    ``[t, triangle + rep]``, a row without a key into ``[3.4e38, 0]``.
    Equal to ``mm_elem_plain`` by construction; the tests hold it so."""
    t, hit = _pair_test(lhs, rhs)
    hit = hit & (t < BIG)
    bits = t.view(torch.int32).to(torch.int64)  # t > 1e-3 on a hit: the sign bit is clear
    tri = torch.arange(t.shape[1], device=lhs.device)
    best = torch.full((lhs.shape[0],), _NO_KEY, dtype=torch.int64, device=lhs.device)
    for rep in range(reps):
        keys = torch.where(hit, bits << 32 | rep << 16 | tri, _NO_KEY)
        best = torch.minimum(best, keys.amin(dim=1))
    none = best == _NO_KEY
    t_best = torch.where(none, BIG, (best >> 32).to(torch.int32).view(torch.float32))
    i_best = torch.where(none, 0, (best >> 16 & 0xFFFF) + (best & 0xFFFF))
    return torch.stack([t_best, i_best.to(torch.float32)], dim=-1)


def _check_mm(lhs, rhs, elem: bool) -> None:
    if (lhs.dim() != 2 or rhs.dim() != 2 or lhs.shape[1] != rhs.shape[0]
            or lhs.dtype != torch.float32 or rhs.dtype != torch.float32):
        raise ValueError("lhs (n, k) and rhs (k, cols) must be float32")
    if elem and (lhs.shape[1] != K or rhs.shape[1] % 4):
        raise ValueError(f"mm_elem takes k = {K} and 4 g columns")
    if not elem and (lhs.shape[1] not in (K, K128) or rhs.shape[1] < OUT_COLS):
        raise ValueError(f"mm takes k = {K} or {K128} and at least {OUT_COLS} columns")


def _device_of(*tensors) -> torch.device:
    dev = tensors[0].device
    if dev.type not in ("cpu", "cuda") or any(t.device != dev for t in tensors):
        raise ValueError("the flash2 probe runs on cpu or cuda tensors, all on one device")
    return dev


def mm(lhs: torch.Tensor, rhs: torch.Tensor, reps: int = REPS):
    """One launch of the product kernel on CUDA tensors (``(out,
    checksum)`` as ``mm_plain``); the plain version on CPU tensors."""
    global LAUNCHES
    _check_mm(lhs, rhs, elem=False)
    dev = _device_of(lhs, rhs)
    if dev.type == "cpu":
        return mm_plain(lhs, rhs, reps)
    lhs, rhs = lhs.contiguous(), rhs.contiguous()
    n = lhs.shape[0]
    out = torch.empty((n, OUT_COLS), dtype=torch.float32, device=dev)
    chk = torch.empty((n,), dtype=torch.int32, device=dev)
    fn = common.bind("probe_mm", "zr_probe_mm_launch", [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P])
    with torch.cuda.device(dev):
        common.launch("probe_mm", fn, lhs.data_ptr(), rhs.data_ptr(), out.data_ptr(),
                      chk.data_ptr(), n, lhs.shape[1], rhs.shape[1], reps, 0)
    LAUNCHES += 1
    return out, chk


def mm_elem(lhs: torch.Tensor, rhs: torch.Tensor, reps: int = REPS) -> torch.Tensor:
    """One launch of the intersect-block kernel on CUDA tensors (its
    keyed winner, then the keys' decoding); the plain version on CPU
    tensors."""
    global LAUNCHES
    _check_mm(lhs, rhs, elem=True)
    dev = _device_of(lhs, rhs)
    if dev.type == "cpu":
        return mm_elem_plain(lhs, rhs, reps)
    lhs, rhs = lhs.contiguous(), rhs.contiguous()
    n = lhs.shape[0]
    keys = torch.empty((n,), dtype=torch.int64, device=dev)
    out = torch.empty((n, 2), dtype=torch.float32, device=dev)
    fn = common.bind("probe_mm", "zr_probe_mm_elem_launch", [_P, _P, _P, _P, _I, _I, _I, _I, _P])
    with torch.cuda.device(dev):
        common.launch("probe_mm", fn, lhs.data_ptr(), rhs.data_ptr(), keys.data_ptr(),
                      out.data_ptr(), n, rhs.shape[1] // 4, reps, 0)
    LAUNCHES += 1
    return out


def _block_reach(bounds: torch.Tensor, o: torch.Tensor, d: torch.Tensor, rb: int) -> torch.Tensor:
    """``(n / rb, C)`` bool: the tool's reach of each chunk box from each
    block's range of origins and directions (``probe_cullwhen`` :285-306)."""
    ob, db = o.reshape(-1, rb, 3), d.reshape(-1, rb, 3)
    omin, omax, dmin, dmax = ob.amin(1), ob.amax(1), db.amin(1), db.amax(1)
    near = torch.zeros((ob.shape[0], bounds.shape[0]), dtype=torch.float32, device=o.device)
    far = torch.full_like(near, BIG)
    for ax in range(3):
        lo, hi = bounds[None, :, ax], bounds[None, :, 3 + ax]
        dl, dh = dmin[:, ax:ax + 1], dmax[:, ax:ax + 1]
        ol, oh = omin[:, ax:ax + 1], omax[:, ax:ax + 1]
        spans = (dl <= 0.0) & (dh >= 0.0)
        il = 1.0 / torch.where(spans, 1.0, dl)
        ih = 1.0 / torch.where(spans, 1.0, dh)
        cs = [(lo - oh) * il, (lo - oh) * ih, (lo - ol) * il, (lo - ol) * ih,
              (hi - oh) * il, (hi - oh) * ih, (hi - ol) * il, (hi - ol) * ih]
        lo_t = hi_t = cs[0]
        for c in cs[1:]:
            lo_t = torch.minimum(lo_t, c)
            hi_t = torch.maximum(hi_t, c)
        near = torch.where(spans, near, torch.maximum(near, lo_t))
        far = torch.where(spans, far, torch.minimum(far, hi_t))
    return near <= far


def flash_cull_plain(planes: torch.Tensor, bounds: torch.Tensor, o: torch.Tensor,
                     d: torch.Tensor, rb: int = RB):
    """(closest t ``(n,)`` f32, BIG on a miss; chunk visits per block
    ``(n / rb,)`` int32): every chunk a block reaches is tested on all of
    its rays."""
    reach = _block_reach(bounds, o, d, rb)
    t_best = torch.full((o.shape[0],), BIG, dtype=torch.float32, device=o.device)
    per_step = max(1, _RAY_BLOCK // rb)
    lanes = torch.arange(rb, device=o.device)
    for ci in range(planes.shape[1]):
        blocks = torch.nonzero(reach[:, ci])[:, 0]
        for s in range(0, blocks.numel(), per_step):
            rays = (blocks[s:s + per_step, None] * rb + lanes).reshape(-1)
            # the tool tests t < t_best too, which changes no minimum below t_best
            tc = chunk_min((*o[rays].unbind(1), *d[rays].unbind(1)), planes[:, ci])
            t_best[rays] = torch.minimum(t_best[rays], tc)
    return t_best, reach.sum(dim=1).to(torch.int32)


def flash_cull_split(planes: torch.Tensor, bounds: torch.Tensor, o: torch.Tensor,
                     d: torch.Tensor):
    """The kernel's schedule on the host: per block of ``RB`` rays the
    reached chunks; share ``k`` of ``CULL_SHARES`` takes the 16 triangles
    ``16k`` onward of each; each share's minimum per ray over its
    triangles from BIG; the shares' minima merged. Returns what
    ``flash_cull_plain`` does, bit for bit (a minimum is exact in any
    order; the tests hold it so)."""
    reach = _block_reach(bounds, o, d, RB)
    t_best = torch.full((o.shape[0],), BIG, dtype=torch.float32, device=o.device)
    width = planes.shape[2] // CULL_SHARES
    for b in range(reach.shape[0]):
        rays = slice(b * RB, (b + 1) * RB)
        ray = (*o[rays].unbind(1), *d[rays].unbind(1))
        reached = planes[:, torch.nonzero(reach[b])[:, 0]]
        parts = [torch.full((RB,), BIG, dtype=torch.float32, device=o.device)]
        if reached.shape[1]:
            parts += [chunk_min(ray, reached[:, :, k * width:(k + 1) * width])
                      for k in range(CULL_SHARES)]
        t_best[rays] = torch.stack(parts).amin(dim=0)
    return t_best, reach.sum(dim=1).to(torch.int32)


def flash_cull(planes: torch.Tensor, bounds: torch.Tensor, o: torch.Tensor, d: torch.Tensor):
    """One launch of the block-cull kernel on CUDA tensors (512 rays a
    block); the plain version on CPU tensors. ``planes`` ``(17+, C,
    128)``, ``bounds`` ``(C, 8)``, ``o``, ``d`` ``(n, 3)``, n a multiple
    of 512."""
    global CULL_LAUNCHES
    c = planes.shape[1] if planes.dim() == 3 else -1
    if (planes.dim() != 3 or planes.shape[0] < 17 or planes.shape[2] != 128
            or bounds.shape != (c, 8) or o.shape != d.shape
            or o.dim() != 2 or o.shape[1] != 3 or o.shape[0] % RB
            or any(x.dtype != torch.float32 for x in (planes, bounds, o, d))):
        raise ValueError(f"planes (17+, C, 128), bounds (C, 8), "
                         f"o and d (n, 3) with n a multiple of {RB}, all float32")
    dev = _device_of(planes, bounds, o, d)
    if dev.type == "cpu":
        return flash_cull_plain(planes, bounds, o, d)
    planes, bounds, o, d = (x.contiguous() for x in (planes, bounds, o, d))
    if planes.data_ptr() % 16:  # the kernel stages 16-byte rows with cp.async
        planes = planes.clone()
    n = o.shape[0]
    out = torch.empty((n,), dtype=torch.float32, device=dev)
    visits = torch.empty((n // RB,), dtype=torch.int32, device=dev)
    fn = common.bind("probe_flash_cull", "zr_probe_flash_cull_launch",
                     [_P, _P, _I, _P, _P, _P, _P, _I, _P])
    with torch.cuda.device(dev):
        common.launch("probe_flash_cull", fn, planes.data_ptr(), bounds.data_ptr(), c,
                      o.data_ptr(), d.data_ptr(), out.data_ptr(), visits.data_ptr(), n)
    CULL_LAUNCHES += 1
    return out, visits


def make_mm_inputs(device, k: int = K, cols: int = NG * G, rows: int = R, seed: int = 0):
    """(lhs, rhs) as the tool draws them: uniform in [0, 1)."""
    rng = np.random.default_rng(seed)
    lhs = rng.random((rows, k)).astype(np.float32)
    rhs = rng.random((k, cols)).astype(np.float32)
    return torch.from_numpy(lhs).to(device), torch.from_numpy(rhs).to(device)


def make_tie_inputs(case: str, device, rows: int = 64, g: int = 96):
    """(lhs, rhs) of mm_elem with many ties, from ``make_mm_inputs`` with
    the u and v blocks scaled by 0.4 so that most pairs hit:
    ``dup_columns`` copies each even triangle's four columns to the odd
    one after it (equal t, the lower triangle wins); ``no_hit_rows``
    negates every other lhs row as well (det < 0: rows with no hit);
    ``all_equal`` gives every triangle the first one's columns."""
    if case not in TIE_CASES:
        raise ValueError(f"unknown case {case!r}; choose from {TIE_CASES}")
    lhs, rhs = make_mm_inputs("cpu", cols=4 * g, rows=rows)
    blocks = rhs.reshape(K, 4, g)
    blocks[:, 1:3] *= 0.4
    if case == "dup_columns":
        blocks[:, :, 1::2] = blocks[:, :, 0:g - g % 2:2]
    elif case == "no_hit_rows":
        lhs[1::2] = -lhs[1::2]
    else:
        blocks[:, :, 1:] = blocks[:, :, :1]
    return lhs.to(device), blocks.reshape(K, 4 * g).contiguous().to(device)


def cull_planes(device):
    """The teapot scene's triangles in BVH order, packed (``TriPlanes``)."""
    from zraytrace_tpu_torch.geometry.bvh import build_tri_bvh
    from zraytrace_tpu_torch.ops.flash_intersect import pack_tri_planes
    from zraytrace_tpu_torch.scenes import teapot_and_ball

    sc = teapot_and_ball("cpu").scene
    order = build_tri_bvh(sc.tri_a, sc.tri_b, sc.tri_c).prim_order
    return pack_tri_planes(sc.tri_a, sc.tri_b, sc.tri_c, order=order).to(device)


def _camera_rays(n: int = N_RAYS, seed: int = 0):
    """(o, d) on the host: scene 3's camera rays at one jittered sample
    per pixel of a ``CAMERA_WIDTH``-wide image, ``n / CAMERA_WIDTH`` rows
    about its middle (all 256 rows at ``N_RAYS``), in pixel order."""
    from zraytrace_tpu_torch.render import camera_rays
    from zraytrace_tpu_torch.scenes import teapot_and_ball

    height = N_RAYS // CAMERA_WIDTH
    rows = n // CAMERA_WIDTH
    first = (height - rows) // 2 * CAMERA_WIDTH
    ids = torch.arange(first, first + n, dtype=torch.int32)
    camera = teapot_and_ball("cpu").camera
    o, d = camera_rays(camera, seed, ids, torch.zeros_like(ids), CAMERA_WIDTH, height)
    return o.contiguous(), d.contiguous()


def cull_rays(device, n: int = N_RAYS, seed: int = 0):
    """{"into": (o, d), "away": (o, d), "camera": (o, d)}: the tool's two
    ray sets and ``_camera_rays``' (``n`` a multiple of 512, at most
    ``N_RAYS``)."""
    rng = np.random.default_rng(seed)
    o = (rng.random((n, 3)) * 4 - 2).astype(np.float32)
    d0 = rng.standard_normal((n, 3))
    d = (d0 / np.linalg.norm(d0, axis=1, keepdims=True)).astype(np.float32)
    o_away = o + np.asarray([0.0, 100.0, 0.0], np.float32)
    d_away = np.broadcast_to(np.asarray([0.0, 1.0, 0.0], np.float32), (n, 3)).copy()
    t = lambda a: torch.from_numpy(a).to(device)
    return {"into": (t(o), t(d)), "away": (t(o_away), t(d_away)),
            "camera": tuple(x.to(device) for x in _camera_rays(n, seed))}


# FP32 operations, counted from csrc/probe_mm.cu and probe_flash_cull.cu
ELEM_FLOPS = 5  # per ray and triangle of mm_elem: 1/det, u, v, t, u + v
PAIR_FLOPS = 40  # per visited ray-triangle pair (flash3_probe's count)
RAY_FLOPS = 9  # o x d per ray
REACH_FLOPS = 3 * (2 + 16)  # per block and chunk: per axis two divisions, 8 subtractions
# and 8 multiplications


def mm_flops(k: int, rows: int = R, cols: int = NG * G, reps: int = REPS) -> int:
    return 2 * rows * k * cols * reps


def mm_elem_flops(rows: int = R, g: int = G, reps: int = REPS) -> int:
    return reps * (2 * rows * K * 4 * g + ELEM_FLOPS * rows * g)


def cull_flops(visits: int, n_blocks: int, nchunk: int, rb: int = RB) -> int:
    """For ``visits`` chunk visits (summed over blocks) of ``rb`` rays."""
    return visits * rb * 128 * PAIR_FLOPS + n_blocks * (rb * RAY_FLOPS + nchunk * REACH_FLOPS)


def _mm_rows(device, variants) -> list[dict]:
    rows = []
    cuda = device.type == "cuda"
    for name in variants:
        row = dict(probe="flash2_probe", variant=name, device=str(device), ms=None, per=None,
                   plain_ms=None, max_abs_err=None)
        k = K128 if name in ("mm128", "library_mm128") else K
        lhs, rhs = make_mm_inputs(device, k)
        if name.startswith("library"):
            if not cuda:
                if name == "library_mm":
                    row["plain_ms"] = common.time_ms(lambda: torch.matmul(lhs, rhs), device,
                                                     repeats=1)[1]
                    rows.append(row)
                continue
            tf32 = name.endswith("tf32")
            saved = torch.backends.cuda.matmul.allow_tf32
            try:
                torch.backends.cuda.matmul.allow_tf32 = tf32
                got = torch.matmul(lhs, rhs)
                ms = common.time_graph(lambda: torch.matmul(lhs, rhs), device)
            finally:
                torch.backends.cuda.matmul.allow_tf32 = saved
            row.update(ms=ms, per=ms * 1e3, unit="us/product")
            if tf32:
                torch.backends.cuda.matmul.allow_tf32 = False
                diff = float((got - torch.matmul(lhs, rhs)).abs().max())
                torch.backends.cuda.matmul.allow_tf32 = saved
                row["note"] = (f"TF32, a precision the port does not use: max |diff| from f32 "
                               f"{diff:.3g}")
            else:
                row["note"] = "f32, TF32 off"
            rows.append(row)
            continue
        fn, plain_fn = (mm_elem, mm_elem_plain) if name == "mm_elem" else (mm, mm_plain)
        plain, row["plain_ms"] = common.time_ms(lambda: plain_fn(lhs, rhs), device, repeats=1)
        if cuda:
            got = fn(lhs, rhs)
            if name == "mm_elem":
                row["max_abs_err"] = common.compare(f"flash2_probe {name}", got, plain)
            else:
                row["max_abs_err"] = max(common.compare(f"flash2_probe {name}", got[0], plain[0]),
                                         common.compare(f"flash2_probe {name} checksum", got[1],
                                                        plain[1]))
            row["ms"] = ms = common.time_graph(lambda: fn(lhs, rhs), device)
            if name == "mm128":
                row.update(per=mm_flops(K128) / (ms * 1e-3) / 1e9, unit="GFLOP/s")
            else:
                row.update(per=ms / REPS * 1e3, unit="us/rep")
        rows.append(row)
    return rows


def _cull_rows(device, variants) -> list[dict]:
    from zraytrace_tpu_torch.ops import flash_intersect as fi

    if not variants:
        return []
    rows = []
    cuda = device.type == "cuda"
    tp = cull_planes(device)
    rays = cull_rays(device)
    block_t = {}
    for name in variants:
        kind, which = name.split("_")
        o, d = rays[which]
        row = dict(probe="flash2_probe", variant=name, device=str(device), ms=None, per=None,
                   unit="ns/ray", max_abs_err=None)
        if kind == "cullwhen":
            (t, visits), row["plain_ms"] = common.time_ms(
                lambda: flash_cull_plain(tp.planes, tp.bounds, o, d), device, repeats=1)
            block_t[which] = t
            row.update(visits=int(visits.sum()), n_blocks=visits.numel(),
                       bytes=sum(x.numel() * x.element_size()
                                 for x in (tp.planes, tp.bounds, o, d, t, visits)),
                       note=(f"{int(visits.sum())} chunk visits over {visits.numel()} blocks "
                             f"({float(visits.float().mean()):.2f} of {tp.n_chunks} per block), "
                             f"{int((t < BIG).sum())} rays hit"))
            if cuda:
                kt, kv = flash_cull(tp.planes, tp.bounds, o, d)
                row["max_abs_err"] = max(common.compare(f"flash2_probe {name}", kt, t),
                                         common.compare(f"flash2_probe {name} visits", kv, visits))
                row["ms"] = common.time_graph(lambda: flash_cull(tp.planes, tp.bounds, o, d),
                                              device)
        else:
            res, row["plain_ms"] = common.time_ms(lambda: fi.flash_intersect_plain(tp, o, d, 1e-3),
                                                  device, repeats=1)
            if which in block_t:
                common.compare(f"flash2_probe {name} vs the block cull", res[0], block_t[which])
                row["note"] = "per-ray cull: t equal to the block cull's"
            if cuda:
                kr = fi.flash_intersect_triangles(tp, o, d, 1e-3)
                row["max_abs_err"] = max(common.compare(f"flash2_probe {name}", x, y)
                                         for x, y in zip(kr, res))
                row["ms"] = common.time_graph(
                    lambda: fi.flash_intersect_triangles(tp, o, d, 1e-3), device)
        if row["ms"] is not None:
            row["per"] = row["ms"] / o.shape[0] * 1e6
        rows.append(row)
    return rows


def measure(device, variants=VARIANTS) -> list[dict]:
    """One row per variant (see ``probes.common``): every kernel equals its
    plain version bit for bit; the library rows are timed only; the
    per-ray cull's t must equal the block cull's. Kernels and library
    calls are timed as CUDA graphs of launches (no host dispatch between
    them)."""
    return (_mm_rows(device, [v for v in variants if v in MM_VARIANTS])
            + _cull_rows(device, [v for v in variants if v in CULL_VARIANTS]))


if __name__ == "__main__":
    sys.exit(common.main_for(measure, VARIANTS, sys.argv[1:]))
