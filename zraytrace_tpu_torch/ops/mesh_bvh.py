"""The bounce kernel's mesh winner: a per-ray stackless walk of the BVH.

The port of ``bvh_closest_triangle`` (``zraytrace_tpu/geometry/bvh.py:
272``) as the triangle winner of the bounce kernel's mesh mode
(``csrc/tri_bvh.cuh``, in place of the 128-triangle chunk scan the TPU's
lane width dictated). Its contract is the flash winner's
(``flash_intersect_plain``): the first triangle in packed order of least
``t`` strictly below ``t_init``. The walk keeps it by construction:

- the builder emits leaves in preorder and their triangles contiguous
  and ascending in ``prim_order``, the order the flash planes are packed
  in, so a left-first walk tests triangles in increasing packed position;
- each triangle is tested in the flash winner's arithmetic and with its
  strict ``t < t_best``;
- a node is entered only when the ray's slab test reaches its box within
  ``(t_min, t_best]``; otherwise the walk jumps to its skip link. The
  running ``t_best`` never falls below the winner's ``t`` before the
  winner is tested, so a cull that never drops a real hit cannot lose it.

The cull is made conservative by testing each node box dilated outward
(``node_table``): leaf boxes are tight, and flat ones occur (an
axis-aligned floor), where a slab test rounding one ulp the wrong way
would drop a hit the chunk scan keeps. A dilated box may in turn admit a
hit that the chunk scan's undilated chunk box dropped; such a hit passes
every triangle test (``tests/test_torch_bvh.py`` checks it).

The tables, made once per mesh (``render.flash_pack_cached``):

- nodes ``(M, 8)`` f32: the dilated ``lo3, hi3``, then, stored as int32
  bits, a leaf's ``(start, count)`` or an internal node's ``(skip, 0)``
  (a leaf's skip is the next node): two 16-byte loads a node;
- rows ``(T, 16)`` f32, one per triangle in packed order: ``fn, a.fn,
  e2, e2 x a, e1, e1 x a``, the flash planes' own values copied, never
  recomputed, so a thread reads a triangle's det and t inputs with one
  16-byte load and the rest with three more.

``bvh_winner_plain`` is the lockstep PyTorch twin of the walk: the same
node order, the same dilated cull and the same per-triangle arithmetic,
with the same work counts. The render's plain route stays the chunk scan
(``flash_intersect_plain``), which is the contract.
"""

from __future__ import annotations

import torch

from zraytrace_tpu_torch.geometry.bvh import TriBVH
from zraytrace_tpu_torch.geometry.sphere import BIG
from zraytrace_tpu_torch.geometry.triangle import DET_EPS
from zraytrace_tpu_torch.ops.flash_intersect import LANE, TriPlanes, _inv_dir, _slab

__all__ = ["NODE_COLS", "ROW_COLS", "WORK_FIELDS", "node_table", "tri_rows", "bvh_tables",
           "check_tables", "bvh_winner_plain"]

NODE_COLS = 8
ROW_COLS = 16
# the flash planes (ops/flash_intersect.py N_COMP order) a row holds, in
# row order: fn, a.fn, e2, e2 x a, e1, e1 x a
ROW_PLANES = (6, 7, 8, 15, 3, 4, 5, 9, 10, 11, 0, 1, 2, 12, 13, 14)
# The work counts of the walk, in order: node slab tests, leaves entered,
# triangle tests, and those passing det, t and u (csrc/tri_bvh.cuh).
WORK_FIELDS = ("nodes", "leaves", "tris", "det", "t", "u")
# A node box is widened on every side by this share of its extent plus
# this share of its largest coordinate magnitude (the only pad of a flat
# box's flat axis). The slab test's own rounding needs ulps of either; the
# triangle test's is larger: at grazing incidence it accepts crossings a
# little outside a triangle, so outside its tight leaf box. On grazing
# rays at flat floors, 2^-6 and 2^-12 were the smallest shares tried that
# dropped none of the chunk scan's hits; these are twice that, at about
# 11% more node tests than tight boxes on the teapot's rays
# (``probes/walk_pad.py``).
PAD_EXTENT = 2.0 ** -5
PAD_MAGNITUDE = 2.0 ** -11


def node_table(bvh: TriBVH) -> torch.Tensor:
    """The walk's node table ``(M, 8)`` f32 from a BVH: each box dilated
    (``PAD_*``), then a leaf's ``(prim_start, prim_count)`` or an internal
    node's ``(skip, 0)`` as int32 bits."""
    lo, hi = bvh.node_min.float(), bvh.node_max.float()
    mag = torch.maximum(lo.abs(), hi.abs()).amax(1, keepdim=True)
    pad = PAD_EXTENT * (hi - lo) + PAD_MAGNITUDE * mag
    leaf = bvh.prim_count > 0
    ref = torch.where(leaf, bvh.prim_start, bvh.skip).to(torch.int32)
    ints = torch.stack([ref, bvh.prim_count.to(torch.int32)], 1).view(torch.float32)
    return torch.cat([lo - pad, hi + pad, ints], 1).contiguous()


def tri_rows(planes: TriPlanes) -> torch.Tensor:
    """The walk's triangle rows ``(T, 16)`` f32: the flash planes' values
    of each real triangle, in packed order (``ROW_PLANES``)."""
    flat = planes.planes[list(ROW_PLANES)].reshape(ROW_COLS, planes.n_chunks * LANE)
    return flat[:, :planes.n_tris].t().contiguous()


def bvh_tables(planes: TriPlanes, bvh: TriBVH) -> TriPlanes:
    """``planes`` with the walk's tables, on the planes' device. ``bvh`` is
    the tree whose ``prim_order`` packed them."""
    if bvh.prim_order.shape[0] != planes.n_tris:
        raise ValueError("the BVH does not hold the planes' triangles")
    dev = planes.planes.device
    return planes._replace(nodes=node_table(bvh).to(dev), rows=tri_rows(planes))


def check_tables(planes: TriPlanes, dev) -> None:
    """What the bounce kernel's mesh mode takes: both tables, contiguous
    f32 on ``dev``, 16-byte aligned, of the planes' triangles."""
    if planes.nodes is None or planes.rows is None:
        raise ValueError("the mesh mode walks the BVH: make the planes' tables with "
                         "bvh_tables() (render.flash_pack_cached does)")
    for name, x in (("nodes", planes.nodes), ("rows", planes.rows)):
        if x.device != dev or x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"planes.{name} must be contiguous float32 on {dev}")
        if x.data_ptr() % 16:
            raise ValueError(f"planes.{name} must be 16-byte aligned")
    m = planes.nodes.shape[0]
    if planes.nodes.dim() != 2 or planes.nodes.shape[1] != NODE_COLS or m < 1 or m >= 1 << 31:
        raise ValueError("planes.nodes must be (M, 8) with 0 < M < 2^31")
    if planes.rows.shape != (planes.n_tris, ROW_COLS):
        raise ValueError(f"planes.rows must be ({planes.n_tris}, {ROW_COLS})")


def bvh_winner_plain(planes: TriPlanes, o, d, t_min, t_init=None):
    """The walk in plain PyTorch, all rays in lockstep: each live ray
    slab-tests its node within ``(t_min, t_best]``; a reached leaf's
    triangles are tested one after another in the flash winner's
    arithmetic, each taking over on a strict ``t < t_best``; the ray then
    moves to the next node, or to the skip link of an internal node it
    missed, until it passes the last node.

    Returns ``((t, idx, hit, uv), work)``: the first as
    ``flash_intersect_plain`` (packed ids and zero ``uv`` where the planes
    carry ``attrs``, else original ids and real ``uv``), ``work`` the counts
    of ``WORK_FIELDS`` as a dict.
    """
    nodes, rows = planes.nodes, planes.rows
    n, dev = o.shape[0], o.device
    f32 = dict(dtype=torch.float32, device=dev)
    ti = (torch.full((n,), BIG, **f32) if t_init is None
          else torch.clamp(t_init.to(torch.float32), max=BIG))
    tb = ti.clone()
    best = torch.zeros((n,), dtype=torch.long, device=dev)
    ub = torch.zeros((n,), **f32)
    vb = torch.zeros((n,), **f32)
    inv = _inv_dir(d)
    ox, oy, oz = o[:, 0], o[:, 1], o[:, 2]
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    pxv = oy * dz - oz * dy
    pyv = oz * dx - ox * dz
    pzv = ox * dy - oy * dx
    ints = nodes[:, 6:8].contiguous().view(torch.int32).long()
    ref, count = ints[:, 0], ints[:, 1]
    m = nodes.shape[0]
    leaf_max = int(count.max())
    work = dict.fromkeys(WORK_FIELDS, 0)
    node = torch.zeros((n,), dtype=torch.long, device=dev)
    live = torch.arange(n, device=dev)
    while live.numel():
        nd = node[live]
        near, far = _slab(nodes[nd, 0:3], nodes[nd, 3:6], o[live], inv[live])
        reach = (near <= far) & (far > t_min) & (near <= tb[live])
        leaf = count[nd] > 0
        enter = reach & leaf
        work["nodes"] += live.numel()
        work["leaves"] += int(enter.sum())
        rays, start, cnt = live[enter], ref[nd[enter]], count[nd[enter]]
        for k in range(leaf_max):
            r = rays[k < cnt]
            pos = start[k < cnt] + k
            (fnx, fny, fnz, adf, e2x, e2y, e2z, qax, qay, qaz,
             e1x, e1y, e1z, rax, ray_, raz) = rows[pos].t()
            rdx, rdy, rdz = dx[r], dy[r], dz[r]
            rpx, rpy, rpz = pxv[r], pyv[r], pzv[r]
            det = -(rdx * fnx + rdy * fny + rdz * fnz)
            safe = torch.abs(det) > 1e-12
            inv_det = 1.0 / torch.where(safe, det, 1.0)
            u = (rpx * e2x + rpy * e2y + rpz * e2z - (rdx * qax + rdy * qay + rdz * qaz)) * inv_det
            v = -(rpx * e1x + rpy * e1y + rpz * e1z - (rdx * rax + rdy * ray_ + rdz * raz)) * inv_det
            t = (ox[r] * fnx + oy[r] * fny + oz[r] * fnz - adf) * inv_det
            det_ok = det >= DET_EPS
            t_ok = det_ok & (t > t_min) & (t < tb[r])
            u_ok = t_ok & (u >= 0.0)
            better = u_ok & (v >= 0.0) & (u + v <= 1.0)
            work["tris"] += r.numel()
            work["det"] += int(det_ok.sum())
            work["t"] += int(t_ok.sum())
            work["u"] += int(u_ok.sum())
            rw = r[better]
            tb[rw] = t[better]
            best[rw] = pos[better]
            ub[rw] = u[better]
            vb[rw] = v[better]
        node[live] = torch.where(reach | leaf, nd + 1, ref[nd])
        live = live[node[live] < m]
    hit = tb < ti
    if planes.attrs is None:  # original ids from the planes, real uv
        orig = planes.planes[17].reshape(-1)
        idx = torch.where(hit, orig[best].to(torch.int32), 0)
        uv = torch.stack([torch.where(hit, ub, 0.0), torch.where(hit, vb, 0.0)], dim=-1)
    else:
        idx = torch.where(hit, best.to(torch.int32), 0)
        uv = torch.zeros((n, 2), **f32)
    return (tb, idx, hit, uv), work
