"""Batched ray-triangle intersection, brute force.

Counterpart of ``zraytrace_tpu/geometry/triangle.py``. Reference
semantics: triangle.zig:48-71 — the determinant form of Möller-Trumbore
with the *unnormalized* face normal ``fn = e1 x e2``, barycentric
``(u, v)`` reused as texture coordinates (triangle.zig:66), and one-sided
culling by ``det >= 1e-6`` (triangle.zig:62; back faces never hit).

With the scalar-triple-product identity every per-(ray, triangle)
quantity is a dot product of a per-ray vector with a per-triangle one:

    det   = -(d . fn)
    u_num =  (o x d) . e2 - d . (e2 x a)
    v_num = -((o x d) . e1 - d . (e1 x a))
    t_num =  o . fn - a . fn

The JAX package forms these as ``(N, 3) @ (3, C)`` matmuls; here they
are explicit component sums ``(x*x' + y*y') + z*z'`` over an ``(N, C)``
broadcast, the order the flash kernel (``ops/flash_intersect.py``) uses.
Triangles stream in chunks of ``TRI_CHUNK``.

This is what the CPU path traces mesh scenes with (the JAX package does
the same off the TPU: no flash planes, no BVH), and it is the oracle of
the flash winner.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from zraytrace_tpu_torch import vecmath as vm
from zraytrace_tpu_torch.geometry.sphere import BIG

DET_EPS = 1e-6  # one-sidedness threshold (triangle.zig:62)

# Triangles per chunk: bounds the (N, CHUNK) intermediates.
TRI_CHUNK = 512


class TrianglePack(NamedTuple):
    """Per-triangle precomputation (triangle.zig:32-46)."""

    e1: torch.Tensor  # (T, 3) b - a
    e2: torch.Tensor  # (T, 3) c - a
    fn: torch.Tensor  # (T, 3) e1 x e2 (unnormalized face normal)
    e2xa: torch.Tensor  # (T, 3)
    e1xa: torch.Tensor  # (T, 3)
    a_dot_fn: torch.Tensor  # (T,)


def pack_triangles(a, b, c) -> TrianglePack:
    e1 = b - a
    e2 = c - a
    fn = vm.cross(e1, e2)
    return TrianglePack(e1=e1, e2=e2, fn=fn, e2xa=vm.cross(e2, a),
                        e1xa=vm.cross(e1, a), a_dot_fn=vm.dot(a, fn))


def _pair_dot(x, y):
    """``(N, 3)`` x ``(C, 3)`` -> ``(N, C)`` dot products, summed x, y, z
    in order."""
    return (x[:, None, 0] * y[None, :, 0] + x[:, None, 1] * y[None, :, 1]
            + x[:, None, 2] * y[None, :, 2])


def _intersect_chunk(o, d, oxd, pack: TrianglePack, t_min, t_max):
    """All rays against one chunk: per-ray best ``(t, local idx, u, v)``,
    the first triangle of the chunk winning exact ties."""
    det = -_pair_dot(d, pack.fn)
    safe = torch.abs(det) > 1e-12
    inv_det = 1.0 / torch.where(safe, det, 1.0)
    u = (_pair_dot(oxd, pack.e2) - _pair_dot(d, pack.e2xa)) * inv_det
    v = -(_pair_dot(oxd, pack.e1) - _pair_dot(d, pack.e1xa)) * inv_det
    t = (_pair_dot(o, pack.fn) - pack.a_dot_fn[None, :]) * inv_det
    is_hit = ((det >= DET_EPS) & (t > t_min) & (t < t_max)
              & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0))
    t = torch.where(is_hit, t, BIG)
    t_best, idx = torch.min(t, dim=-1)  # first minimal index
    pick = lambda x: torch.gather(x, 1, idx[:, None])[:, 0]
    return t_best, idx.to(torch.int32), pick(u), pick(v)


def intersect_triangles(o, d, a, b, c, t_min, t_max, chunk: int = TRI_CHUNK):
    """Closest valid triangle hit per ray (brute force, chunked).

    ``o, d`` ``(N, 3)``; ``a, b, c`` ``(T, 3)``; ``t_min, t_max`` numbers.
    Returns ``t (N,)`` (``BIG`` where none), ``idx (N,)`` int32, ``hit
    (N,)`` bool, ``uv (N, 2)``. Earlier triangles win exact ties
    (raytrace.zig:75-81): first-wins inside a chunk, strict ``<`` across.
    """
    n, T = o.shape[0], a.shape[0]
    f32 = dict(dtype=torch.float32, device=o.device)
    if T == 0:
        return (torch.full((n,), BIG, **f32), torch.zeros((n,), dtype=torch.int32, device=o.device),
                torch.zeros((n,), dtype=torch.bool, device=o.device), torch.zeros((n, 2), **f32))
    oxd = vm.cross(o, d)
    if T <= chunk:
        t, idx, u, v = _intersect_chunk(o, d, oxd, pack_triangles(a, b, c), t_min, t_max)
        return t, idx, t < BIG, torch.stack([u, v], dim=-1)

    # pad with degenerate triangles (fn = 0 => det = 0 < DET_EPS: no hit)
    n_chunks = -(-T // chunk)
    pad = n_chunks * chunk - T
    pad3 = lambda x: torch.cat([x, x.new_zeros((pad, 3))])
    pack = pack_triangles(pad3(a), pad3(b), pad3(c))
    bt = torch.full((n,), BIG, **f32)
    bidx = torch.zeros((n,), dtype=torch.int32, device=o.device)
    bu = torch.zeros((n,), **f32)
    bv = torch.zeros((n,), **f32)
    for i in range(n_chunks):
        part = TrianglePack(*(x[i * chunk:(i + 1) * chunk] for x in pack))
        ct, cidx, cu, cv = _intersect_chunk(o, d, oxd, part, t_min, t_max)
        better = ct < bt  # strict: the earlier chunk keeps ties
        bt = torch.where(better, ct, bt)
        bidx = torch.where(better, cidx + i * chunk, bidx)
        bu = torch.where(better, cu, bu)
        bv = torch.where(better, cv, bv)
    return bt, bidx, bt < BIG, torch.stack([bu, bv], dim=-1)


def triangle_surface(o, d, t, idx, a, b, c):
    """Point and unit outward face normal (before the front-face flip) of
    triangle ``idx`` per ray (triangle.zig:44-46,67-69). ``normalize_safe``
    keeps a degenerate triangle 0 (a miss lane's idx defaults to 0)."""
    i = idx.long()
    av, bv, cv = a[i], b[i], c[i]
    normal = vm.normalize_safe(vm.cross(bv - av, cv - av))
    return vm.ray_at(o, d, t), normal
