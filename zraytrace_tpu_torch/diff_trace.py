"""Mesh-scale differentiable closest hit (winner-recompute).

Counterpart of ``zraytrace_tpu/diff_trace.py``. Differentiating the brute
O(N*T) triangle scan would scatter-add every (ray, triangle) product in
the backward pass, although at fixed topology only the winner's carry a
gradient. The query is split instead:

1. WINNER PASS (no gradient): the winning triangle per ray, from the
   flash winner over original-id planes (``pack_for_diff``) — its CUDA
   kernel for tensors on the card, any lane count — or from the brute
   scan without planes. It runs under ``torch.no_grad()``.
2. RECOMPUTE (differentiable): the winner's vertices are gathered and the
   Möller-Trumbore determinant form (triangle.zig:48-71) is recomputed
   per ray on that one triangle, so the backward pass scatter-adds into
   one triangle per ray.

Spheres keep the differentiable full scan (a handful per scene).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from zraytrace_tpu_torch import vecmath as vm
from zraytrace_tpu_torch.config import T_MIN
from zraytrace_tpu_torch.geometry.sphere import BIG, intersect_spheres, sphere_surface
from zraytrace_tpu_torch.geometry.triangle import intersect_triangles
from zraytrace_tpu_torch.ops import flash_intersect as fi
from zraytrace_tpu_torch.scene import Scene


class Winner(NamedTuple):
    """The winner pass's output: does a triangle win, and which (original
    id; meaningless where ``use_tri`` is False)."""

    use_tri: torch.Tensor  # (N,) bool
    idx: torch.Tensor  # (N,) int32


def pack_for_diff(scene: Scene) -> fi.TriPlanes:
    """Flash planes for the winner pass and the margin selection: BVH-leaf
    order, packed without the ``attrs`` table, so the kernels return
    original triangle ids. Built from the detached vertices."""
    from zraytrace_tpu_torch.geometry.bvh import build_tri_bvh

    a, b, c = (x.detach() for x in (scene.tri_a, scene.tri_b, scene.tri_c))
    order = build_tri_bvh(a, b, c).prim_order
    return fi.pack_tri_planes(a, b, c, order=order)


@torch.no_grad()
def tri_winner_ids(scene: Scene, o, d, ts, t_min=T_MIN, t_max=BIG, tri_flash=None) -> Winner:
    """The winner pass (``_tri_winner_ids``, ``zraytrace_tpu/diff_trace.py:63``).
    ``ts`` ``(N,)``: each ray's closest sphere t; it seeds the flash winner
    and decides the strict triangle-beats-sphere merge."""
    o, d, ts = o.detach(), d.detach(), ts.detach()
    if tri_flash is not None:
        if tri_flash.attrs is not None:
            raise ValueError("the differentiable winner pass needs original ids: "
                             "pack via pack_for_diff()")
        _, idx, tri_won, _ = fi.flash_intersect_triangles(tri_flash, o, d, t_min, t_init=ts)
        return Winner(tri_won, idx)
    tt, idx, _, _ = intersect_triangles(o, d, scene.tri_a.detach(), scene.tri_b.detach(),
                                        scene.tri_c.detach(), t_min, t_max)
    return Winner(tt < ts, idx)


def _tri_recompute(o, d, av, bv, cv):
    """Differentiable Möller-Trumbore on one gathered triangle per ray
    (the determinant form of ``geometry/triangle.py``). Returns ``(t, u,
    v, unit_normal)``; the 1/det guard keeps inactive lanes finite."""
    e1 = bv - av
    e2 = cv - av
    fn = vm.cross(e1, e2)
    det = -vm.dot(d, fn)
    safe = torch.abs(det) > 1e-12
    inv_det = 1.0 / torch.where(safe, det, 1.0)
    oxd = vm.cross(o, d)
    u = (vm.dot(oxd, e2) - vm.dot(d, vm.cross(e2, av))) * inv_det
    v = -(vm.dot(oxd, e1) - vm.dot(d, vm.cross(e1, av))) * inv_det
    t = (vm.dot(o, fn) - vm.dot(av, fn)) * inv_det
    return t, u, v, vm.normalize_safe(fn)


@torch.no_grad()
def winner_t(scene: Scene, o, d, ts, winner: Winner):
    """``trace_closest_diff``'s hit distance from the winner pass's result
    and the sphere t ``ts``, bit for bit, without its surface and material
    work: the margin selection's ``t_cap`` (BIG on a miss)."""
    ti = winner.idx.long()
    t_rec = _tri_recompute(o, d, scene.tri_a[ti], scene.tri_b[ti], scene.tri_c[ti])[0]
    return torch.where(winner.use_tri, t_rec, ts)


def sphere_scan(scene: Scene, o, d, t_min=T_MIN, t_max=BIG):
    """Differentiable closest sphere ``(t (N,), idx (N,))``; ``t`` is BIG
    where none (and always for a scene without spheres)."""
    n = o.shape[0]
    if scene.n_spheres > 0:
        ts, si, _ = intersect_spheres(o, d, scene.sph_center, scene.sph_radius, t_min, t_max)
        return ts, si
    return (torch.full((n,), BIG, dtype=torch.float32, device=o.device),
            torch.zeros((n,), dtype=torch.int32, device=o.device))


def trace_closest_diff(scene: Scene, o, d, t_min=T_MIN, t_max=BIG, tri_flash=None,
                       winner: Winner | None = None):
    """Drop-in for ``render.trace_closest`` with mesh-scale gradients
    (``zraytrace_tpu/diff_trace.py:110``): the same hit dict, differentiable
    with respect to every scene float leaf and ``(o, d)``. ``winner``: the
    winner pass's result when the caller ran it already (``render_diff``
    runs it before its checkpointed bounce, so the backward pass launches
    no kernel); else it runs here."""
    n = o.shape[0]
    if scene.n_triangles == 0:
        from zraytrace_tpu_torch.render import trace_closest

        return trace_closest(scene, o, d, t_min, t_max)

    ts, si = sphere_scan(scene, o, d, t_min, t_max)
    if winner is None:
        winner = tri_winner_ids(scene, o, d, ts, t_min, t_max, tri_flash)
    use_tri, ti = winner
    ti = ti.long()
    av, bv, cv = scene.tri_a[ti], scene.tri_b[ti], scene.tri_c[ti]
    t_rec, u_rec, v_rec, n_t = _tri_recompute(o, d, av, bv, cv)
    # double-where: the recomputed t, u, v of non-winner lanes can be wild
    uv_t = torch.stack([torch.where(use_tri, u_rec, 0.0), torch.where(use_tri, v_rec, 0.0)], -1)
    t = torch.where(use_tri, torch.where(use_tri, t_rec, 1.0), ts)
    hit = t.detach() < BIG
    t_attr = torch.where(hit, t, 1.0)

    if scene.n_spheres > 0:
        p_s, n_s, uv_s = sphere_surface(o, d, t_attr, si, scene.sph_center, scene.sph_radius)
        mat_s = scene.sph_mat[si.long()]
    else:
        p_s = n_s = torch.zeros_like(o)
        uv_s = torch.zeros((n, 2), dtype=torch.float32, device=o.device)
        mat_s = torch.zeros((n,), dtype=torch.int32, device=o.device)

    u3 = use_tri[:, None]
    point = torch.where(u3, vm.ray_at(o, d, t_attr), p_s)
    outward = torch.where(u3, n_t, n_s)
    uv = torch.where(u3, uv_t, uv_s)
    mat_id = torch.where(use_tri, scene.tri_mat[ti], mat_s)
    front_face = vm.dot(d, outward) <= 0.0
    normal = torch.where(front_face[:, None], outward, -outward)
    return dict(hit=hit, t=t, point=point, normal=normal, front_face=front_face, uv=uv,
                mat_id=mat_id)
