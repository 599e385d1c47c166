"""Axis-aligned bounding boxes.

Counterpart of ``zraytrace_tpu/geometry/aabb.py``: construction from
min/max (aabb.zig:37), vertex lists (aabb.zig:44-66), box merge
(aabb.zig:68-71) and list merge (aabb.zig:73-82), volume (aabb.zig:84-97),
the reference's surface "area" (aabb.zig:99-107: ``2(dx^2+dy^2+dz^2)``,
not the true box area, kept verbatim for parity; the SAH builder uses the
true formula) and the slab test (aabb.zig:109-128).

Boxes are ``(..., 2, 3)`` f32 tensors (rows ``[min, max]``), batched like
the rest of the geometry. Nothing on the render path uses them: the BVH
builder (``native/bvh_builder.cpp``) and the kernels' walks keep their own
boxes. The module stands beside the reference's for parity.
"""

from __future__ import annotations

import torch

__all__ = ["from_min_max", "from_vertices", "merge", "merge_all", "volume",
           "surface_area_reference", "surface_area", "hit"]


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def from_min_max(bmin, bmax) -> torch.Tensor:
    """aabb.zig:37-42."""
    return torch.stack([_f32(bmin), _f32(bmax)], dim=-2)


def from_vertices(vertices) -> torch.Tensor:
    """Bounding box of a ``(..., V, 3)`` vertex set (aabb.zig:44-66)."""
    v = _f32(vertices)
    return torch.stack([v.amin(dim=-2), v.amax(dim=-2)], dim=-2)


def merge(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Union of two boxes (aabb.zig:68-71)."""
    return torch.stack([torch.minimum(a[..., 0, :], b[..., 0, :]),
                        torch.maximum(a[..., 1, :], b[..., 1, :])], dim=-2)


def merge_all(boxes: torch.Tensor) -> torch.Tensor:
    """Union of a ``(N, 2, 3)`` box list (aabb.zig:73-82)."""
    return torch.stack([boxes[..., 0, :].amin(dim=-2), boxes[..., 1, :].amax(dim=-2)], dim=-2)


def volume(box: torch.Tensor) -> torch.Tensor:
    """aabb.zig:84-97."""
    d = box[..., 1, :] - box[..., 0, :]
    return d[..., 0] * d[..., 1] * d[..., 2]


def surface_area_reference(box: torch.Tensor) -> torch.Tensor:
    """The reference's formula, kept verbatim: ``2(dx^2+dy^2+dz^2)``
    (aabb.zig:99-107). Not the true box surface area."""
    d = box[..., 1, :] - box[..., 0, :]
    return 2.0 * (d * d).sum(dim=-1)


def surface_area(box: torch.Tensor) -> torch.Tensor:
    """True box surface area ``2(dx dy + dy dz + dz dx)``, what a
    binned-SAH build optimizes."""
    d = box[..., 1, :] - box[..., 0, :]
    return 2.0 * (d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2] + d[..., 2] * d[..., 0])


def hit(box: torch.Tensor, o, inv_d, t_min, t_max) -> torch.Tensor:
    """Slab test (aabb.zig:109-128): per-axis crossing distances with the
    swap replaced by min/max, broadcast over rays and boxes. ``inv_d`` is
    ``1 / direction``, precomputed."""
    o, inv_d = _f32(o), _f32(inv_d)
    t0 = (box[..., 0, :] - o) * inv_d
    t1 = (box[..., 1, :] - o) * inv_d
    near = torch.minimum(t0, t1)
    far = torch.maximum(t0, t1)
    enter = torch.clamp(near.amax(dim=-1), min=t_min)
    exit_ = torch.clamp(far.amin(dim=-1), max=t_max)
    return enter <= exit_
