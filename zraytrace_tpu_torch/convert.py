"""Crossing over from numpy: how scenes and cameras enter the port.

Both packages can render the identical scene from the same arrays, e.g.
``scene_from_numpy({k: np.asarray(v) for k, v in jax_scene._asdict().items()})``.
"""

from __future__ import annotations

import numpy as np
import torch

from zraytrace_tpu_torch.camera import Camera
from zraytrace_tpu_torch.scene import Scene

_INT_FIELDS = frozenset(
    ("sph_mat", "tri_mat", "mat_type", "mat_tex", "tex_type", "tex_image", "atlas_hw"))


def scene_from_numpy(fields: dict[str, np.ndarray], device="cpu") -> Scene:
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


def camera_from_numpy(origin, lower_left, horizontal, vertical, device="cpu") -> Camera:
    """A ``Camera`` from four ``(3,)`` arrays (the fields of the JAX
    ``Camera`` in order: ``camera_from_numpy(*map(np.asarray, jax_cam))``)."""
    return Camera(*(
        torch.from_numpy(np.array(v, dtype=np.float32).reshape(3)).to(device)
        for v in (origin, lower_left, horizontal, vertical)))
