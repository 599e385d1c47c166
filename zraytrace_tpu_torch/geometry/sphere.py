"""Batched ray-sphere intersection.

Counterpart of ``zraytrace_tpu/geometry/sphere.py``: the fused winner of
sphere-only scenes, the general ``intersect_spheres`` of mixed scenes, and
the hit attributes. Reference semantics: sphere.zig:31-69 — half-b
quadratic, near root preferred, far root only when the near one is out of
range (origin inside), spherical uv from acos/atan2, and a signed radius
giving inward normals for the hollow-glass bubble.

The quadratic uses the reference's o-decomposition with explicit
component sums, in the reference's order:
``cc = |o|^2 - 2 (o.c) + (c.c - r^2)``. This line cancels catastrophically
for the r = 100 ground sphere, so the summation order is part of the
result.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from zraytrace_tpu_torch import vecmath as vm

BIG = float(np.float32(3.4e38))  # "no hit" t, below f32 inf


def intersect_spheres_fused(o, d, centers, radii, mat_ids, t_min, t_max):
    """Closest sphere hit with the winner's attributes, as a running
    winner over the (few) spheres. Strict ``<`` keeps the first sphere on
    ties (raytrace.zig:75-81).

    Returns dict(t, hit, center (N,3), radius (N,), mat_id (N,)).
    """
    n = o.shape[0]
    ox, oy, oz = o[:, 0], o[:, 1], o[:, 2]
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    o_dot_d = vm.dot(o, d)
    o_sq = vm.length_squared(o)
    t_best = torch.full((n,), BIG, dtype=torch.float32, device=o.device)
    c_sel = torch.zeros((n, 3), dtype=torch.float32, device=o.device)
    r_sel = torch.ones((n,), dtype=torch.float32, device=o.device)
    m_sel = torch.zeros((n,), dtype=torch.int32, device=o.device)
    one = torch.ones((), dtype=torch.float32, device=o.device)
    for s in range(centers.shape[0]):
        c = centers[s]
        cx, cy, cz = c[0], c[1], c[2]
        r = radii[s]
        half_b = o_dot_d - (dx * cx + dy * cy + dz * cz)
        c_sq = cx * cx + cy * cy + cz * cz
        cc = o_sq - 2.0 * (ox * cx + oy * cy + oz * cz) + (c_sq - r * r)
        disc = half_b * half_b - cc
        pos = disc > 0.0
        root = torch.where(pos, vm.sqrt(torch.where(pos, disc, one)), 0.0)
        t1 = -half_b - root
        t2 = -half_b + root
        ok1 = (t1 > t_min) & (t1 < t_max)
        ok2 = (t2 > t_min) & (t2 < t_max)
        t = torch.where(ok1, t1, t2)
        valid = (disc >= 0.0) & (ok1 | ok2)
        better = valid & (t < t_best)
        t_best = torch.where(better, t, t_best)
        c_sel = torch.where(better[:, None], c, c_sel)
        r_sel = torch.where(better, r, r_sel)
        m_sel = torch.where(better, mat_ids[s], m_sel)
    return dict(t=t_best, hit=t_best < BIG, center=c_sel, radius=r_sel, mat_id=m_sel)


def intersect_spheres(o, d, centers, radii, t_min, t_max):
    """Closest valid sphere hit per ray over all ``S`` spheres at once,
    the general form the mixed-scene query uses (the JAX function builds
    the ``(N, S)`` terms with matmuls; here they are component sums).
    The values are those of ``intersect_spheres_fused``.

    Returns ``t (N,)`` (``BIG`` where none), ``idx (N,)`` int32 (0 where
    none, the first sphere winning exact ties) and ``hit (N,)``.
    """
    o_dot_d = vm.dot(o, d)[:, None]
    o_sq = vm.length_squared(o)[:, None]
    ct = centers.T  # (3, S)
    d_dot_c = d[:, 0:1] * ct[0] + d[:, 1:2] * ct[1] + d[:, 2:3] * ct[2]
    o_dot_c = o[:, 0:1] * ct[0] + o[:, 1:2] * ct[1] + o[:, 2:3] * ct[2]
    c_sq = vm.length_squared(centers) - radii * radii
    half_b = o_dot_d - d_dot_c
    cc = o_sq - 2.0 * o_dot_c + c_sq[None, :]
    disc = half_b * half_b - cc
    pos = disc > 0.0
    one = torch.ones((), dtype=torch.float32, device=o.device)
    root = torch.where(pos, vm.sqrt(torch.where(pos, disc, one)), 0.0)
    t1 = -half_b - root
    t2 = -half_b + root
    ok1 = (t1 > t_min) & (t1 < t_max)
    ok2 = (t2 > t_min) & (t2 < t_max)
    t = torch.where(ok1, t1, t2)
    valid = (disc >= 0.0) & (ok1 | ok2)
    t = torch.where(valid, t, BIG)
    t_best, idx = torch.min(t, dim=-1)  # first minimal index
    return t_best, idx.to(torch.int32), t_best < BIG


def _safe_radius(radius: torch.Tensor) -> torch.Tensor:
    """Keep 1/radius finite for a radius at zero (sign preserved)."""
    tiny = torch.where(radius < 0, -1e-8, 1e-8).to(radius.dtype)
    return torch.where(torch.abs(radius) > 1e-8, radius, tiny)


def sphere_attributes(o, d, t, center, radius):
    """Point, outward normal (scaled by the signed radius) and spherical
    uv (sphere.zig:43-52) from the carried winner attributes."""
    point = vm.ray_at(o, d, t)
    normal = (point - center) / _safe_radius(radius)[:, None]
    # clip a hair inside [-1, 1] and nudge the atan2 pole, as the reference
    ny = torch.clamp(normal[:, 1], -1.0 + 1e-7, 1.0 - 1e-7)
    theta = torch.arccos(-ny)
    nx = normal[:, 0]
    nz = normal[:, 2]
    pole = (torch.abs(nx) + torch.abs(nz)) < 1e-12
    nx = torch.where(pole, 1e-12, nx)
    phi = torch.atan2(-nz, -nx) + math.pi
    uv = torch.stack([vm.div(phi, 2.0 * math.pi), vm.div(theta, math.pi)], dim=-1)
    return point, normal, uv


def sphere_surface(o, d, t, idx, centers, radii):
    """Point, outward normal and uv of sphere ``idx`` per ray
    (sphere.zig:43-52). The JAX function selects the rows with a
    gather-free where-chain (``onehot_rows``); a gather gives the same
    values."""
    i = idx.long()
    return sphere_attributes(o, d, t, centers[i], radii[i])
