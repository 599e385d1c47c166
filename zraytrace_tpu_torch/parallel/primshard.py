"""Triangles split over the ranks: each rank intersects its share.

Counterpart of ``zraytrace_tpu/parallel/primshard.py``. When a mesh
outgrows one card, its triangles are split over the ``data`` axis (rays
replicated), each rank finds the closest hit among its share, and the
winners meet in all-reduces: the closest hit is an associative minimum.
The per-share test is ``geometry/triangle.intersect_triangles``, as the
JAX package runs its XLA brute force here, not a kernel.

Ties keep the list order (raytrace.zig:75-81): the winner is the
lexicographic minimum of (t, global triangle id), made of a MIN over t,
a MIN over the ids of the rays' closest t, and a SUM of the winner's uv.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from zraytrace_tpu_torch.geometry.sphere import BIG
from zraytrace_tpu_torch.geometry.triangle import intersect_triangles
from zraytrace_tpu_torch.parallel.mesh import DATA_AXIS, Mesh

__all__ = ["make_sharded_intersector"]

_IMAX = 2**31 - 1


def make_sharded_intersector(mesh: Mesh, n_tris: int, t_min: float = 1e-3):
    """``fn(a, b, c, o, d) -> (t, idx, hit, uv)`` over all ``n_tris``
    triangles ``(T, 3)`` and the rays ``(N, 3)``, every rank passing the
    same arrays: each rank of the ``data`` axis tests its contiguous share
    of the triangles, padded with degenerate ones (never hit) to a
    multiple of the axis size; every rank returns the same winners.
    Collective over the ``data`` axis."""
    n_data = mesh.shape[DATA_AXIS]
    per = -(-n_tris // n_data)
    pad = per * n_data - n_tris
    shard = mesh.coords[0]
    group = mesh.group(DATA_AXIS)

    def fn(a, b, c, o, d):
        if a.shape[0] != n_tris:
            raise ValueError(f"built for {n_tris} triangles, got {a.shape[0]}")
        if pad:
            a, b, c = (torch.cat([x, x.new_zeros((pad, 3))]) for x in (a, b, c))
        lo = shard * per
        t, idx, hit, uv = intersect_triangles(o, d, a[lo:lo + per], b[lo:lo + per],
                                              c[lo:lo + per], t_min, BIG)
        gidx = torch.where(hit, idx + lo, _IMAX)
        t_all = t.clone()
        dist.all_reduce(t_all, dist.ReduceOp.MIN, group=group)
        mine = t == t_all
        idx_all = torch.where(mine, gidx, _IMAX)
        dist.all_reduce(idx_all, dist.ReduceOp.MIN, group=group)
        win = mine & (gidx == idx_all) & hit
        uv_all = torch.where(win[:, None], uv, 0.0)
        dist.all_reduce(uv_all, group=group)
        hit_all = t_all < BIG
        return t_all, torch.where(hit_all, idx_all, 0), hit_all, uv_all

    return fn
