"""Differentiable per-model transforms (instancing).

Counterpart of ``zraytrace_tpu/transforms.py``. The reference sketches
translate/scale/rotate on ``Geometry`` but never finishes them
(geometry.zig:29-50). Here a ``Pose`` of tensors moves scene vertices and
sphere centers; every leaf may require grad, so pose parameters receive
gradients through ``render_diff``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from zraytrace_tpu_torch import vecmath as vm
from zraytrace_tpu_torch.scene import Scene


class Pose(NamedTuple):
    """Rigid(+scale) transform: x -> R(rotation) @ (scale * x) + translation.
    ``rotation`` is an axis-angle vector (Rodrigues); all leaves f32."""

    translation: torch.Tensor  # (3,)
    rotation: torch.Tensor  # (3,) axis-angle
    scale: torch.Tensor  # () uniform scale

    @classmethod
    def identity(cls, device="cuda") -> "Pose":
        f32 = dict(dtype=torch.float32, device=device)
        return cls(torch.zeros(3, **f32), torch.zeros(3, **f32), torch.ones((), **f32))


def rotation_matrix(axis_angle: torch.Tensor) -> torch.Tensor:
    """Rodrigues' formula ``(3, 3)``; the identity below ``theta^2 = 1e-16``."""
    theta2 = (axis_angle * axis_angle).sum()
    theta = vm.sqrt(theta2 + 1e-24)
    kx, ky, kz = axis_angle / theta
    zero = torch.zeros_like(kx)
    K = torch.stack([torch.stack([zero, -kz, ky]), torch.stack([kz, zero, -kx]),
                     torch.stack([-ky, kx, zero])])
    eye = torch.eye(3, dtype=axis_angle.dtype, device=axis_angle.device)
    R = eye + torch.sin(theta) * K + (1.0 - torch.cos(theta)) * (K @ K)
    return torch.where(theta2 > 1e-16, R, eye)


def apply_points(pose: Pose, points: torch.Tensor) -> torch.Tensor:
    """Transform ``(..., 3)`` points."""
    R = rotation_matrix(pose.rotation)
    return (pose.scale * points) @ R.T + pose.translation


def transform_triangles(scene: Scene, pose: Pose, tri_mask=None) -> Scene:
    """Scene with (a subset of) triangles transformed. ``tri_mask``: an
    optional ``(T,)`` bool selecting the triangles that move."""
    def move(v):
        moved = apply_points(pose, v)
        return moved if tri_mask is None else torch.where(tri_mask[:, None], moved, v)

    return scene._replace(tri_a=move(scene.tri_a), tri_b=move(scene.tri_b),
                          tri_c=move(scene.tri_c))


def transform_spheres(scene: Scene, pose: Pose, sph_mask=None) -> Scene:
    """Scene with (a subset of) sphere centers transformed; radii scale by
    the pose's uniform scale (signed radii keep their sign)."""
    centers = apply_points(pose, scene.sph_center)
    radii = scene.sph_radius * pose.scale
    if sph_mask is not None:
        centers = torch.where(sph_mask[:, None], centers, scene.sph_center)
        radii = torch.where(sph_mask, radii, scene.sph_radius)
    return scene._replace(sph_center=centers, sph_radius=radii)
