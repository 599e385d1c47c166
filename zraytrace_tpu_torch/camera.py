"""Pinhole camera (camera.zig:17-53); counterpart of
``zraytrace_tpu/camera.py``. No aperture or defocus, like the reference."""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from zraytrace_tpu_torch import vecmath as vm


class Camera(NamedTuple):
    """Derived camera frame (camera.zig:11-15): four ``(3,)`` f32 tensors."""

    origin: torch.Tensor
    lower_left: torch.Tensor
    horizontal: torch.Tensor
    vertical: torch.Tensor

    def to(self, device) -> "Camera":
        return Camera(*(t.to(device) for t in self))

    def flat(self) -> torch.Tensor:
        """``(12,)`` f32: origin, lower_left, horizontal, vertical."""
        return torch.cat(list(self)).to(torch.float32)


def _host_f32(v) -> torch.Tensor:
    """``v`` as an f32 tensor on the host. A tensor keeps its autograd
    graph (``Tensor.to`` is differentiable); anything else goes through
    numpy."""
    if isinstance(v, torch.Tensor):
        return v.to(device="cpu", dtype=torch.float32)
    return torch.as_tensor(np.asarray(v, np.float32))


def make_camera(look_from, look_at, vup, vfov_degrees, aspect_ratio,
                device="cuda") -> Camera:
    """Build the camera frame (camera.zig:17-45), in f32 like the JAX
    reference (``h`` is ``tan`` of an f32 angle). Computed on the host,
    so every device gets the same frame, then moved to ``device``.

    Differentiable, like the JAX function: ``look_from``, ``look_at``,
    ``vup`` and ``vfov_degrees`` may be tensors that require grad, and
    the frame carries their graph. A number ``vfov_degrees`` is turned
    into its angle in f64 and rounded once; a tensor one in f32.
    """
    look_from, look_at, vup = _host_f32(look_from), _host_f32(look_at), _host_f32(vup)
    if isinstance(vfov_degrees, torch.Tensor):
        theta = _host_f32(vfov_degrees) * math.pi / 180.0
    else:
        theta = _host_f32(math.pi * vfov_degrees / 180.0)
    h = torch.tan(theta / 2.0)
    viewport_height = 2.0 * h
    viewport_width = aspect_ratio * viewport_height
    w = vm.normalize(look_from - look_at)
    u = vm.normalize(torch.linalg.cross(vup, w))
    v = torch.linalg.cross(w, u)
    horizontal = u * viewport_width
    vertical = v * viewport_height
    lower_left = look_from - horizontal * 0.5 - vertical * 0.5 - w
    return Camera(look_from, lower_left, horizontal, vertical).to(device)


def get_rays(camera: Camera, u: torch.Tensor, v: torch.Tensor):
    """Batched ``Camera.getRay`` (camera.zig:46-52). ``u``/``v`` are
    viewport coordinates, any shape ``(...)``. Returns ``(origins,
    directions)`` of shape ``(..., 3)``, directions normalized by division
    (ray.zig:11-13)."""
    d = (
        camera.lower_left
        + u[..., None] * camera.horizontal
        + v[..., None] * camera.vertical
        - camera.origin
    )
    d = vm.normalize(d)
    o = camera.origin.expand(d.shape)
    return o, d


def pixel_uv(x, y, jitter_u, jitter_v, width, height):
    """Viewport coords for pixel (x, y) with sub-pixel jitter
    (raytrace.zig:174-175). Row 0 is the image bottom. ``width`` and
    ``height`` are Python numbers."""
    u = vm.div(x + jitter_u - 0.5, width)
    v = vm.div(y + jitter_v - 0.5, height)
    return u, v
