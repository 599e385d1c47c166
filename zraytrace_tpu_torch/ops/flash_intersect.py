"""The flash closest-triangle winner: packed triangle planes, chunk
culling and a running per-ray winner.

Replaces the TPU kernel ``_kernel_rl`` (``zraytrace_tpu/ops/
flash_intersect.py:589``, reached from ``flash_intersect_triangles``
``:1055``) and, with the same contract, the older ``_kernel`` /
``_winner_scan`` (``:401``). The CUDA source, with the design note, is
``csrc/flash_intersect.cu``: one ray per group of lanes spread over a
chunk's triangles (``csrc/tri_winner_warp.cuh``, shared with the margin
kernel). Its result is that of the per-ray sequential scan in packed
order, ``flash_intersect_plain``; the bounce kernel's mesh mode reaches
the same winner by a per-ray BVH walk (``ops/mesh_bvh.py``).

Triangles are sorted into BVH-leaf order (``geometry/bvh.py``) and packed
as 18 component planes of ``(C, 128)`` chunks with one AABB per chunk.
A ray tests a chunk's 128 triangles only when its own slab test reaches
the chunk's box within ``(t_min, t_best]``, where ``t_best`` is its
running winner, seeded with ``t_init`` (e.g. the closest sphere):
triangles past the seed lose anyway, and the strict ``<`` keeps exact
ties on the seed. The TPU kernel's rays-on-lanes layout, per-block SMEM
work lists, ray sorting, group bounds, coarse phase and near exit are its
machinery, not its contract; on the GPU each ray culls for itself.

``flash_intersect_triangles`` launches the kernel for CUDA tensors and
runs ``flash_intersect_plain`` (the same function in plain PyTorch) for
CPU tensors; nothing falls back.

The same planes, packed with original ids, feed the silhouette-margin
selection of the differentiable path: ``flash_margin_select`` launches
``csrc/flash_margins.cu`` (replacing ``_kernel_rl_margins``, ``:870``)
for CUDA tensors and runs ``flash_margin_select_plain`` for CPU tensors.
Each launch adds to the store's counter ``launch.flash`` or
``launch.margins`` (``profiling``).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from zraytrace_tpu_torch import vecmath as vm
from zraytrace_tpu_torch.geometry.sphere import BIG
from zraytrace_tpu_torch.geometry.triangle import DET_EPS
from zraytrace_tpu_torch.profiling import count

__all__ = ["TriPlanes", "pack_tri_planes", "root_box", "ray_chunk_reach",
           "flash_intersect_plain", "flash_intersect_triangles", "WORK_FIELDS",
           "FLASH_WORK_FIELDS",
           "library", "LANE", "N_COMP", "dilated_bounds", "flash_margin_select_plain",
           "flash_margin_select", "MARGIN_WORK_FIELDS", "margins_library"]

LANE = 128  # triangles per chunk
# packed component planes, each (n_chunks, 128):
# e1(3) e2(3) fn(3) e2xa(3) e1xa(3) a_dot_fn(1) valid(1) orig_id(1)
N_COMP = 18
# The work counts ``flash_intersect_triangles(..., work=)`` receives, in
# order: chunk slab tests, chunk visits (128 triangle tests each), and the
# triangle tests passing the det, t and u stages, in the sequential scan's
# order (csrc/flash_intersect.cu).
WORK_FIELDS = ("slab", "visits", "det", "t", "u")
# The work counts ``flash_intersect_triangles(..., work=)`` receives: those
# of the sequential scan (``WORK_FIELDS``), then the triangle tests passing
# t and u as the flash kernel's lanes made them, each against its own
# running best rather than the winner shrinking mid-chunk
# (csrc/flash_intersect.cu).
FLASH_WORK_FIELDS = WORK_FIELDS + ("t_warp", "u_warp")
# The work counts ``flash_margin_select(..., work=)`` receives: chunk slab
# tests, chunk visits, and the triangle tests passing det and t > t_min
# (csrc/flash_margins.cu).
MARGIN_WORK_FIELDS = ("slab", "visits", "det", "t")

_I, _P, _F = ctypes.c_int, ctypes.c_void_p, ctypes.c_float


class TriPlanes(NamedTuple):
    """Packed triangles, as the JAX package's ``TriPlanes`` without its
    TPU layouts (``planes_rl``, group bounds, coarse subset)."""

    planes: torch.Tensor  # (N_COMP, C, 128) f32
    bounds: torch.Tensor  # (C, 8) f32 chunk AABB [lo3, hi3, 0, 0]
    root: torch.Tensor  # (6,) f32 [lo3, hi3], the union of the chunk boxes
    n_tris: int
    # (C*128, 4) [unit face normal xyz, material id] by packed id
    # chunk*128 + lane, for const-material meshes: then the winner's id
    # is the packed id and uv is zero (const materials never read it)
    attrs: torch.Tensor | None = None
    # the BVH walk's tables (ops/mesh_bvh.py bvh_tables): nodes (M, 8)
    # and triangle rows (T, 16) in packed order
    nodes: torch.Tensor | None = None
    rows: torch.Tensor | None = None

    def to(self, device) -> "TriPlanes":
        move = lambda x: None if x is None else x.to(device)
        return TriPlanes(self.planes.to(device), self.bounds.to(device), self.root.to(device),
                         self.n_tris, move(self.attrs), move(self.nodes), move(self.rows))

    @property
    def n_chunks(self) -> int:
        return self.planes.shape[1]


def root_box(bounds):
    """The mesh root box ``(6,)`` [lo3, hi3] over chunk boxes ``(C, 8)``:
    the bounce kernel's mesh mode tests it before it walks the BVH."""
    return torch.cat([bounds[:, 0:3].amin(0), bounds[:, 3:6].amax(0)]).contiguous()


def pack_tri_planes(a, b, c, order=None, tri_mat=None, const_materials=False) -> TriPlanes:
    """Pack triangles ``(T, 3)`` into planes (``zraytrace_tpu/ops/
    flash_intersect.py:197``). ``order`` (a BVH's ``prim_order``) sorts
    them into spatially tight chunks; the original id rides along as a
    plane. Padding triangles have valid = 0 and fn = 0 (never hit) and
    inherit the last real triangle's bounds. ``tri_mat`` with
    ``const_materials`` adds the ``attrs`` table, whose unit normal is
    computed with the operations of ``triangle_surface``."""
    T = a.shape[0]
    if T == 0:
        raise ValueError("cannot pack zero triangles")
    if order is not None:
        order = torch.as_tensor(order).to(device=a.device, dtype=torch.long)
        a, b, c = a[order], b[order], c[order]
        orig = order.to(torch.float32)
    else:
        orig = torch.arange(T, dtype=torch.float32, device=a.device)
    n_chunks = -(-T // LANE)
    pad = n_chunks * LANE - T
    p3 = lambda x: torch.cat([x, x.new_zeros((pad, 3))])
    a_, b_, c_ = p3(a), p3(b), p3(c)
    e1 = b_ - a_
    e2 = c_ - a_
    fn = vm.cross(e1, e2)
    e2xa = vm.cross(e2, a_)
    e1xa = vm.cross(e1, a_)
    adf = vm.dot(a_, fn)
    valid = torch.cat([torch.ones((T,)), torch.zeros((pad,))]).to(a.device)
    orig = torch.cat([orig, orig.new_zeros((pad,))])
    comps = [e1[:, 0], e1[:, 1], e1[:, 2], e2[:, 0], e2[:, 1], e2[:, 2],
             fn[:, 0], fn[:, 1], fn[:, 2], e2xa[:, 0], e2xa[:, 1], e2xa[:, 2],
             e1xa[:, 0], e1xa[:, 1], e1xa[:, 2], adf, valid, orig]
    planes = torch.stack([x.reshape(n_chunks, LANE) for x in comps]).contiguous()

    lo = torch.minimum(torch.minimum(a_, b_), c_)
    hi = torch.maximum(torch.maximum(a_, b_), c_)
    if pad:
        lo[T:] = lo[T - 1]
        hi[T:] = hi[T - 1]
    bounds = torch.cat([lo.reshape(n_chunks, LANE, 3).amin(1), hi.reshape(n_chunks, LANE, 3).amax(1),
                        lo.new_zeros((n_chunks, 2))], dim=1).contiguous()

    attrs = None
    if tri_mat is not None and const_materials:
        fn_unit = vm.normalize_safe(vm.cross(b_ - a_, c_ - a_))
        tm = torch.as_tensor(tri_mat).to(a.device, torch.float32)
        if order is not None:
            tm = tm[order]
        tm = torch.cat([tm, tm.new_zeros((pad,))])
        attrs = torch.cat([fn_unit, tm[:, None]], dim=1).contiguous()
    return TriPlanes(planes=planes, bounds=bounds, root=root_box(bounds), n_tris=T, attrs=attrs)


def _inv_dir(d):
    """``1 / d`` with ``|d| < 1e-30`` (and ±0) replaced by ``+1e-30``: the
    slab test then degenerates to "origin inside the slab", which never
    excludes a reachable chunk."""
    return 1.0 / torch.where(torch.abs(d) < 1e-30, 1e-30, d)


def _slab(lo, hi, o, inv):
    """Entry and exit distance of rays ``(k, 3)`` through boxes ``lo, hi``
    (broadcasting). Returns ``(near, far)``."""
    t1 = (lo - o) * inv
    t2 = (hi - o) * inv
    return torch.minimum(t1, t2).amax(-1), torch.maximum(t1, t2).amin(-1)


def ray_chunk_reach(bounds, o, d, t_cap, t_min):
    """``(n, C)`` bool: does ray ``n`` reach chunk ``C``'s box within
    ``(t_min, t_cap[n]]``? (``_ray_chunk_reach``, ``zraytrace_tpu/ops/
    flash_intersect.py:306``.)"""
    near, far = _slab(bounds[None, :, 0:3], bounds[None, :, 3:6], o[:, None, :],
                      _inv_dir(d)[:, None, :])
    return (near <= far) & (far > t_min) & (near <= t_cap[:, None])


def flash_intersect_plain(planes: TriPlanes, o, d, t_min, t_init=None):
    """The flash winner in plain PyTorch, chunk after chunk: the rays that
    reach a chunk within their running winner are gathered and tested
    against its 128 triangles in the kernel's arithmetic order, and the
    first triangle of least ``t`` strictly below the winner takes over.

    Returns ``(t, idx, hit, uv)`` as ``flash_intersect_triangles``.
    """
    n, dev = o.shape[0], o.device
    f32 = dict(dtype=torch.float32, device=dev)
    ti = (torch.full((n,), BIG, **f32) if t_init is None
          else torch.clamp(t_init.to(torch.float32), max=BIG))
    tb = ti.clone()
    best = torch.zeros((n,), dtype=torch.int32, device=dev)
    ub = torch.zeros((n,), **f32)
    vb = torch.zeros((n,), **f32)
    inv = _inv_dir(d)
    ox, oy, oz = o[:, 0], o[:, 1], o[:, 2]
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    pxv = oy * dz - oz * dy
    pyv = oz * dx - ox * dz
    pzv = ox * dy - oy * dx
    need_uv = planes.attrs is None
    for ci in range(planes.n_chunks):
        box = planes.bounds[ci]
        near, far = _slab(box[0:3], box[3:6], o, inv)
        rays = torch.nonzero((near <= far) & (far > t_min) & (near <= tb))[:, 0]
        if rays.numel() == 0:
            continue
        g = lambda x: x[rays][:, None]
        rdx, rdy, rdz = g(dx), g(dy), g(dz)
        rpx, rpy, rpz = g(pxv), g(pyv), g(pzv)
        (e1x, e1y, e1z, e2x, e2y, e2z, fnx, fny, fnz,
         qax, qay, qaz, rax, ray_, raz, adf, _, orig) = planes.planes[:, ci, :]
        det = -(rdx * fnx + rdy * fny + rdz * fnz)
        safe = torch.abs(det) > 1e-12
        inv_det = 1.0 / torch.where(safe, det, 1.0)
        u = (rpx * e2x + rpy * e2y + rpz * e2z - (rdx * qax + rdy * qay + rdz * qaz)) * inv_det
        v = -(rpx * e1x + rpy * e1y + rpz * e1z - (rdx * rax + rdy * ray_ + rdz * raz)) * inv_det
        t = (g(ox) * fnx + g(oy) * fny + g(oz) * fnz - adf) * inv_det
        t_run = tb[rays]
        better = ((det >= DET_EPS) & (t > t_min) & (u >= 0.0) & (v >= 0.0)
                  & (u + v <= 1.0) & (t < t_run[:, None]))
        t_chunk, j = torch.min(torch.where(better, t, BIG), dim=1)  # first minimal
        won = better.any(dim=1)
        rw, jw = rays[won], j[won]
        tb[rw] = t_chunk[won]
        if need_uv:
            best[rw] = orig[jw].to(torch.int32)
            ub[rw] = u[won, jw]
            vb[rw] = v[won, jw]
        else:
            best[rw] = (ci * LANE + jw).to(torch.int32)
    return tb, best, tb < ti, torch.stack([ub, vb], dim=-1)


def library() -> ctypes.CDLL:
    """The kernel's library, built from ``csrc/flash_intersect.cu`` on first
    use (``ops/build.py``)."""
    from zraytrace_tpu_torch.ops.build import load

    lib = load("flash_intersect")
    if lib.zr_flash_launch.argtypes is None:
        lib.zr_flash_launch.argtypes = [_P, _P, _I, _I, _P, _P, _P, _F, _I, _P, _P, _P, _P, _P,
                                        _P]
        lib.zr_flash_launch.restype = _I
        lib.zr_error_string.argtypes = [_I]
        lib.zr_error_string.restype = ctypes.c_char_p
    return lib


def check_planes(planes: TriPlanes, dev) -> None:
    """What the CUDA kernels take: contiguous f32 planes on ``dev``."""
    tensors = [("planes", planes.planes), ("bounds", planes.bounds), ("root", planes.root)]
    if planes.attrs is not None:
        tensors.append(("attrs", planes.attrs))
    for name, x in tensors:
        if x.device != dev or x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"planes.{name} must be contiguous float32 on {dev}")
    c = planes.n_chunks
    if (planes.planes.shape != (N_COMP, c, LANE) or planes.bounds.shape != (c, 8)
            or planes.root.shape != (6,)):
        raise ValueError("planes must be (18, C, 128) with bounds (C, 8) and root (6,)")
    if planes.attrs is not None and planes.attrs.shape != (c * LANE, 4):
        raise ValueError("attrs must be (C*128, 4)")


def flash_intersect_triangles(planes: TriPlanes, o, d, t_min, t_init=None, work=None):
    """Closest triangle per ray, the contract of the JAX function
    (``zraytrace_tpu/ops/flash_intersect.py:1055``): returns ``(t (N,),
    idx (N,) int32, hit (N,) bool, uv (N, 2))``.

    ``idx`` is the original triangle id with real barycentric ``uv`` —
    except when ``planes.attrs`` is present: then it is the packed id
    (chunk*128 + lane) indexing ``attrs``, and ``uv`` is zero. Misses
    report id 0. ``t_init`` ``(N,)`` seeds the running winner: ``t``
    equals ``t_init`` where no triangle beat it, and ``hit`` is True only
    where a triangle won. Any ``N``. ``work``, an int64 tensor of
    ``len(FLASH_WORK_FIELDS)`` on the card, has the work done added to it by
    a counting build of the kernel (slower; for pricing a bound). The plain
    version counts nothing.
    """
    dev = o.device
    if dev.type == "cpu":
        return flash_intersect_plain(planes, o, d, t_min, t_init)
    if dev.type != "cuda":
        raise ValueError(f"flash_intersect_triangles runs on cpu or cuda tensors, not {dev.type}")
    n = o.shape[0]
    check_planes(planes, dev)
    for name, x in (("o", o), ("d", d)):
        if x.device != dev or x.dtype != torch.float32 or x.shape != (n, 3):
            raise ValueError(f"{name} must be ({n}, 3) float32 on {dev}")
    o, d = o.contiguous(), d.contiguous()
    ti = None
    if t_init is not None:
        if t_init.device != dev or t_init.shape != (n,):
            raise ValueError(f"t_init must be ({n},) on {dev}")
        ti = t_init.to(torch.float32).contiguous()
    if work is not None and (work.device != dev or work.dtype != torch.int64
                             or work.shape != (len(FLASH_WORK_FIELDS),)):
        raise ValueError(f"work must be an int64 ({len(FLASH_WORK_FIELDS)},) tensor on {dev}")
    t = torch.empty((n,), dtype=torch.float32, device=dev)
    idx = torch.empty((n,), dtype=torch.int32, device=dev)
    hit = torch.empty((n,), dtype=torch.bool, device=dev)
    uv = torch.empty((n, 2), dtype=torch.float32, device=dev)
    lib = library()
    attrs = planes.attrs is not None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.zr_flash_launch(
            planes.planes.data_ptr(), planes.bounds.data_ptr(), planes.n_chunks, int(attrs),
            o.data_ptr(), d.data_ptr(), None if ti is None else ti.data_ptr(), float(t_min), n,
            t.data_ptr(), idx.data_ptr(), hit.data_ptr(), uv.data_ptr(),
            None if work is None else work.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"flash kernel launch failed: {lib.zr_error_string(err).decode()}")
    count("launch.flash")
    return t, idx, hit, uv


def dilated_bounds(bounds):
    """Chunk boxes ``(C, 8)`` widened on every side by half their extent
    plus 1e-3 (``flash_margin_select``, ``zraytrace_tpu/ops/
    flash_intersect.py:1007-1011``): a near-missing ray can pass outside a
    chunk's box while its barycentric margin is still small. The margin
    kernel widens the boxes itself with the same arithmetic."""
    lo, hi = bounds[:, 0:3], bounds[:, 3:6]
    pad = 0.5 * (hi - lo) + 1e-3
    return torch.cat([lo - pad, hi + pad, bounds[:, 6:8]], dim=1).contiguous()


def _margin_windows(t_cap):
    """Per ray: the reach cap (``2 * t_cap``, or ``t_cap`` itself from
    1e30 up, a miss ray) and the 1e-5 relative guards around ``t_cap``."""
    tc = t_cap.to(torch.float32)
    return torch.where(tc >= 1e30, tc, 2.0 * tc), tc * 1.00001, tc * 0.99999


def _first_best(vals, run, largest: bool):
    """Per row of ``vals`` ``(k, 128)``: the best value and the first lane
    holding it, and whether it strictly beats ``run`` ``(k,)``."""
    best = vals.amax(1) if largest else vals.amin(1)
    lane = torch.arange(vals.shape[1], device=vals.device)
    j = torch.where(vals == best[:, None], lane, vals.shape[1]).amin(1)
    return best, j, (best > run) if largest else (best < run)


def flash_margin_select_plain(planes: TriPlanes, o, d, t_cap, t_min):
    """The margin selection in plain PyTorch, chunk after chunk: the rays
    whose own slab test reaches a chunk's dilated box within ``(t_min,
    cap]`` are gathered and tested against its 128 triangles in the
    kernel's arithmetic order; each running best takes the first triangle
    that strictly beats it. Every mask requires ``det >= 1e-6`` and
    ``t > t_min`` (the occlusion mask through ``t > t_cap * (1 + 1e-5)``,
    as a hit's ``t_cap`` exceeds ``t_min``).

    Returns ``(near_id, occ_id, win_id)`` as ``flash_margin_select``.
    """
    if planes.attrs is not None:
        raise ValueError("margin selection needs original ids: pack the planes without "
                         "attrs (diff_trace.pack_for_diff)")
    n, dev = o.shape[0], o.device
    tc = t_cap.to(torch.float32)
    cap, texcl, tlow = _margin_windows(tc)
    bd = dilated_bounds(planes.bounds)
    f32 = dict(dtype=torch.float32, device=dev)
    mb = torch.full((n,), -BIG, **f32)
    tob = torch.full((n,), BIG, **f32)
    twb = torch.full((n,), BIG, **f32)
    ids = torch.full((3, n), -1, dtype=torch.int32, device=dev)  # near, occ, win
    inv = _inv_dir(d)
    ox, oy, oz = o[:, 0], o[:, 1], o[:, 2]
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    pxv = oy * dz - oz * dy
    pyv = oz * dx - ox * dz
    pzv = ox * dy - oy * dx
    for ci in range(planes.n_chunks):
        box = bd[ci]
        near, far = _slab(box[0:3], box[3:6], o, inv)
        rays = torch.nonzero((near <= far) & (far > t_min) & (near <= cap))[:, 0]
        if rays.numel() == 0:
            continue
        g = lambda x: x[rays][:, None]
        rdx, rdy, rdz = g(dx), g(dy), g(dz)
        rpx, rpy, rpz = g(pxv), g(pyv), g(pzv)
        (e1x, e1y, e1z, e2x, e2y, e2z, fnx, fny, fnz,
         qax, qay, qaz, rax, ray_, raz, adf, _, orig) = planes.planes[:, ci, :]
        det = -(rdx * fnx + rdy * fny + rdz * fnz)
        safe = torch.abs(det) > 1e-12
        inv_det = 1.0 / torch.where(safe, det, 1.0)
        u = (rpx * e2x + rpy * e2y + rpz * e2z - (rdx * qax + rdy * qay + rdz * qaz)) * inv_det
        v = -(rpx * e1x + rpy * e1y + rpz * e1z - (rdx * rax + rdy * ray_ + rdz * raz)) * inv_det
        t = (g(ox) * fnx + g(oy) * fny + g(oz) * fnz - adf) * inv_det
        m = torch.minimum(torch.minimum(u, v), 1.0 - u - v)
        ok = (det >= DET_EPS) & (t > t_min)
        inside = ok & (m >= 0.0)
        occ = inside & (t > g(texcl))
        cands = (
            (mb, torch.where(ok & (t < g(tc)) & (m < 0.0), m, -BIG), True),
            (tob, torch.where(occ, t, BIG), False),
            (twb, torch.where(inside & ~occ & (t >= g(tlow)), t, BIG), False),
        )
        for k, (run, vals, largest) in enumerate(cands):
            best, j, better = _first_best(vals, run[rays], largest)
            rw = rays[better]
            run[rw] = best[better]
            ids[k, rw] = orig[j[better]].to(torch.int32)
    return ids[0], ids[1], ids[2]


def margins_library() -> ctypes.CDLL:
    """The margin kernel's library, built from ``csrc/flash_margins.cu`` on
    first use (``ops/build.py``)."""
    from zraytrace_tpu_torch.ops.build import load

    lib = load("flash_margins")
    if lib.zr_margins_launch.argtypes is None:
        lib.zr_margins_launch.argtypes = [_P, _P, _I, _P, _P, _P, _F, _I, _P, _P, _P, _P, _P]
        lib.zr_margins_launch.restype = _I
        lib.zr_error_string.argtypes = [_I]
        lib.zr_error_string.restype = ctypes.c_char_p
    return lib


def flash_margin_select(planes: TriPlanes, o, d, t_cap, t_min, work=None):
    """Silhouette-margin selection, the contract of the JAX function
    (``zraytrace_tpu/ops/flash_intersect.py:982``): per ray, ``(near_id,
    occ_id, win_id)`` ``(N,)`` int32 original triangle ids, -1 where no
    triangle qualified —

    - near: the largest barycentric margin ``m = min(u, v, 1-u-v) < 0``
      among front crossings with ``t_min < t < t_cap``;
    - occ: the least ``t > t_cap * (1 + 1e-5)`` among interior crossings;
    - win: the least ``t`` among interior crossings within the 1e-5
      relative guards around ``t_cap``.

    ``t_cap`` ``(N,)`` is the ray's hit distance (3.4e38 on a miss). Chunks
    count when the ray reaches their dilated box within ``(t_min,
    2 * t_cap]``. Ties go to the first triangle in packed order; the TPU
    kernel picks the lowest sublane. ``planes`` must carry original ids
    (no ``attrs``). Any ``N``. ``work``, an int64 tensor of
    ``len(MARGIN_WORK_FIELDS)`` on the card, receives the work done from a
    counting build of the kernel (slower; for pricing a bound). Launches
    ``csrc/flash_margins.cu`` for CUDA tensors and runs
    ``flash_margin_select_plain`` for CPU tensors.
    """
    if planes.attrs is not None:
        raise ValueError("margin selection needs original ids: pack the planes without "
                         "attrs (diff_trace.pack_for_diff)")
    dev = o.device
    if dev.type == "cpu":
        return flash_margin_select_plain(planes, o, d, t_cap, t_min)
    if dev.type != "cuda":
        raise ValueError(f"flash_margin_select runs on cpu or cuda tensors, not {dev.type}")
    n = o.shape[0]
    check_planes(planes, dev)
    for name, x in (("o", o), ("d", d)):
        if x.device != dev or x.dtype != torch.float32 or x.shape != (n, 3):
            raise ValueError(f"{name} must be ({n}, 3) float32 on {dev}")
    if t_cap.device != dev or t_cap.shape != (n,):
        raise ValueError(f"t_cap must be ({n},) on {dev}")
    if work is not None and (work.device != dev or work.dtype != torch.int64
                             or work.shape != (len(MARGIN_WORK_FIELDS),)):
        raise ValueError(f"work must be an int64 ({len(MARGIN_WORK_FIELDS)},) tensor on {dev}")
    o, d = o.contiguous(), d.contiguous()
    tc = t_cap.to(torch.float32).contiguous()
    ids = torch.empty((3, n), dtype=torch.int32, device=dev)
    lib = margins_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.zr_margins_launch(
            planes.planes.data_ptr(), planes.bounds.data_ptr(), planes.n_chunks, o.data_ptr(),
            d.data_ptr(), tc.data_ptr(), float(t_min), n, ids[0].data_ptr(), ids[1].data_ptr(),
            ids[2].data_ptr(), None if work is None else work.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"margin kernel launch failed: {lib.zr_error_string(err).decode()}")
    count("launch.margins")
    return ids[0], ids[1], ids[2]
