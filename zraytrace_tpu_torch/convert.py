"""Crossing over from numpy: how scenes and cameras enter the port.

Both packages can render the identical scene from the same arrays, e.g.
``scene_from_numpy({k: np.asarray(v) for k, v in jax_scene._asdict().items()},
"cpu")``, trace the same packed triangles (``tri_planes_from_numpy``),
and differentiate from the same parameters (``params_from_numpy``,
``pose_from_numpy``). Every function takes the device; the default is the
card.
"""

from __future__ import annotations

import numpy as np
import torch

from zraytrace_tpu_torch.camera import Camera
from zraytrace_tpu_torch.ops.flash_intersect import TriPlanes, root_box
from zraytrace_tpu_torch.scene import Scene

_INT_FIELDS = frozenset(
    ("sph_mat", "tri_mat", "mat_type", "mat_tex", "tex_type", "tex_image", "atlas_hw"))


def scene_from_numpy(fields: dict[str, np.ndarray], device="cuda") -> Scene:
    """A ``Scene`` from its 16 fields as arrays (f32, or int32 for the
    structure tables). Missing or extra fields raise."""
    if set(fields) != set(Scene._fields):
        raise ValueError(
            f"scene fields differ: missing {set(Scene._fields) - set(fields)}, "
            f"extra {set(fields) - set(Scene._fields)}")
    out = {}
    for k in Scene._fields:
        dtype = np.int32 if k in _INT_FIELDS else np.float32
        arr = np.ascontiguousarray(np.asarray(fields[k]), dtype=dtype)
        out[k] = torch.from_numpy(arr.copy()).to(device)
    return Scene(**out)


def camera_from_numpy(origin, lower_left, horizontal, vertical, device="cuda") -> Camera:
    """A ``Camera`` from four ``(3,)`` arrays (the fields of the JAX
    ``Camera`` in order: ``camera_from_numpy(*map(np.asarray, jax_cam))``)."""
    return Camera(*(
        torch.from_numpy(np.array(v, dtype=np.float32).reshape(3)).to(device)
        for v in (origin, lower_left, horizontal, vertical)))


def tri_planes_from_numpy(planes, bounds, n_tris: int, attrs=None, device="cuda") -> TriPlanes:
    """``TriPlanes`` from the packed arrays (the fields of the JAX
    ``TriPlanes`` of the same name: planes ``(18, C, 128)``, bounds ``(C,
    8)``, attrs ``(C*128, 4)`` or None)."""
    f32 = lambda x: torch.from_numpy(np.array(x, dtype=np.float32)).to(device)
    bounds = f32(bounds)
    return TriPlanes(f32(planes), bounds, root_box(bounds), int(n_tris),
                     None if attrs is None else f32(attrs))


def params_from_numpy(params: dict, device="cuda") -> dict:
    """Scene parameters (the JAX package's ``inverse.split_scene`` params,
    a subset of ``DIFF_FIELDS``, as arrays) as f32 tensors on ``device``.
    Unknown fields raise."""
    from zraytrace_tpu_torch.inverse import DIFF_FIELDS

    extra = set(params) - set(DIFF_FIELDS)
    if extra:
        raise ValueError(f"not differentiable scene fields: {sorted(extra)}")
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)).to(device)
            for k, v in params.items()}


def pose_from_numpy(translation, rotation, scale, device="cuda"):
    """A ``transforms.Pose`` from arrays (the fields of the JAX ``Pose``
    in order: ``pose_from_numpy(*map(np.asarray, jax_pose))``)."""
    from zraytrace_tpu_torch.transforms import Pose

    f32 = lambda x, shape: torch.from_numpy(np.array(x, dtype=np.float32).reshape(shape)).to(
        device)
    return Pose(f32(translation, (3,)), f32(rotation, (3,)), f32(scale, ()))
