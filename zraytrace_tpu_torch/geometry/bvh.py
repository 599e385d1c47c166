"""Bounding volume hierarchy over triangles: the host build.

Counterpart of ``zraytrace_tpu/geometry/bvh.py`` ``build_tri_bvh`` and
``TriBVH``: a binned-SAH build (16 bins, leaves of 4) computed by the
port's C++ builder (``native/bvh_builder.cpp``). The mesh path uses only
its ``prim_order``, to sort triangles into spatially tight 128-triangle
chunks for the flash winner (``ops/flash_intersect.py``), so that is what
``TriBVH`` holds, with the node count. The node arrays feed only the JAX
package's traversal ``bvh_closest_triangle``, which is not on the render
path and is not ported (ROADMAP.md Queue 1, item 8).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

LEAF_SIZE = 4


class TriBVH(NamedTuple):
    """What the mesh path takes from a BVH over ``T`` triangles."""

    prim_order: torch.Tensor  # (T,) int32 permutation of triangle ids, leaf order
    n_nodes: int


def build_tri_bvh(a, b, c, leaf_size: int = LEAF_SIZE) -> TriBVH:
    """Build over triangle vertex arrays ``(T, 3)`` (tensors or arrays)."""
    from zraytrace_tpu_torch.native.api import build_bvh_native

    a, b, c = (np.asarray(torch.as_tensor(x).cpu(), np.float32) for x in (a, b, c))
    if a.shape[0] == 0:
        raise ValueError("cannot build a BVH over zero triangles")
    lo = np.minimum(np.minimum(a, b), c)
    hi = np.maximum(np.maximum(a, b), c)
    order, n_nodes = build_bvh_native(lo, hi, leaf_size)
    return TriBVH(torch.from_numpy(order), n_nodes)
