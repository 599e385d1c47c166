"""Bounding volume hierarchy over triangles: the host build.

Counterpart of ``zraytrace_tpu/geometry/bvh.py`` ``build_tri_bvh``,
``TriBVH`` and ``bvh_depth_stats``: a binned-SAH build (16 bins, leaves
of 4) computed by the port's C++ builder (``native/bvh_builder.cpp``),
flattened in preorder with skip links. Its ``prim_order`` sorts the
triangles into the packed order of the flash planes
(``ops/flash_intersect.py``); its nodes are the tree the bounce kernel's
mesh mode walks (``ops/mesh_bvh.py``, the port of the JAX traversal
``bvh_closest_triangle``).

Layout: node 0 is the root; an internal node's left child is the next
node and its right child follows the left subtree; ``skip`` is where a
walk goes when the node's box is missed (an internal node's subtree end,
a leaf's next node, ``M`` when done). A leaf holds ``prim_count > 0``
triangles from ``prim_start`` in ``prim_order``, so the leaves' ranges
are contiguous and ascending in preorder.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from zraytrace_tpu_torch.profiling import span

LEAF_SIZE = 4


class TriBVH(NamedTuple):
    """Flattened BVH over ``T`` triangles, ``M`` nodes (host tensors)."""

    node_min: torch.Tensor  # (M, 3) f32
    node_max: torch.Tensor  # (M, 3) f32
    prim_start: torch.Tensor  # (M,) int32, a leaf's first position in prim_order
    prim_count: torch.Tensor  # (M,) int32, 0 for internal nodes
    skip: torch.Tensor  # (M,) int32 escape index (M = done)
    prim_order: torch.Tensor  # (T,) int32 permutation of triangle ids, leaf order

    @property
    def n_nodes(self) -> int:
        return self.node_min.shape[0]


@span("bvh.build")
def build_tri_bvh(a, b, c, leaf_size: int = LEAF_SIZE) -> TriBVH:
    """Build over triangle vertex arrays ``(T, 3)`` (tensors or arrays)."""
    from zraytrace_tpu_torch.native.api import build_bvh_native

    a, b, c = (np.asarray(torch.as_tensor(x).detach().cpu(), np.float32) for x in (a, b, c))
    if a.shape[0] == 0:
        raise ValueError("cannot build a BVH over zero triangles")
    lo = np.minimum(np.minimum(a, b), c)
    hi = np.maximum(np.maximum(a, b), c)
    return TriBVH(*(torch.from_numpy(x) for x in build_bvh_native(lo, hi, leaf_size)))


def bvh_depth_stats(bvh: TriBVH) -> dict:
    """Host-side sanity stats (``bvh_depth_stats``,
    ``zraytrace_tpu/geometry/bvh.py:208``), the analogue of the
    reference's depth tracking (bvh.zig:23-30, "Max depth in BVH is 13").

    An internal node's children are the next node and the node after the
    left subtree, so a preorder walk tracks depth with a stack of subtree
    ends (``skip``) and no recursion.
    """
    skip = np.asarray(bvh.skip)
    count = np.asarray(bvh.prim_count)
    max_depth = 0
    ends: list[int] = []
    for node in range(len(skip)):
        while ends and node >= ends[-1]:
            ends.pop()
        max_depth = max(max_depth, len(ends))
        if count[node] == 0:
            ends.append(int(skip[node]) if skip[node] > node else len(skip))
    return dict(n_nodes=len(skip), n_leaves=int((count > 0).sum()), max_depth=int(max_depth),
                max_leaf_size=int(count.max()))
