"""ctypes bindings of the host library (``native/*.cpp``), built with g++
at first use (``ops/build.py`` ``build_host``); counterpart of
``zraytrace_tpu/native/api.py``. There is no fallback: a machine without
g++ raises."""

from __future__ import annotations

import ctypes

import numpy as np

_F = ctypes.POINTER(ctypes.c_float)
_I = ctypes.POINTER(ctypes.c_int32)


class ObjParseError(ValueError):
    """A face with fewer than 3 or more than 6 vertices
    (obj_reader.zig:80-82,104-106)."""


def _lib() -> ctypes.CDLL:
    from zraytrace_tpu_torch.ops.build import load_host

    lib = load_host()
    if lib.zrt_build_bvh.argtypes is None:
        lib.zrt_build_bvh.restype = ctypes.c_int64
        lib.zrt_build_bvh.argtypes = [_F, _F, ctypes.c_int64, ctypes.c_int32,
                                      _F, _F, _I, _I, _I, _I, ctypes.c_int64]
        lib.zrt_parse_obj.restype = ctypes.c_int32
        lib.zrt_parse_obj.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64), _F, _I]
    return lib


def _fptr(a):
    return a.ctypes.data_as(_F)


def _iptr(a):
    return a.ctypes.data_as(_I)


def build_bvh_native(lo: np.ndarray, hi: np.ndarray, leaf_size: int):
    """Binned-SAH build over primitive bounds ``(n, 3)``. Returns the
    preorder skip-link layout ``(node_min (M, 3) f32, node_max (M, 3) f32,
    prim_start (M,) int32, prim_count (M,) int32, skip (M,) int32,
    prim_order (n,) int32)`` of ``geometry/bvh.py`` ``TriBVH``."""
    n = lo.shape[0]
    lo = np.ascontiguousarray(lo, np.float32)
    hi = np.ascontiguousarray(hi, np.float32)
    max_nodes = 4 * n // max(leaf_size, 1) + 16
    node_min = np.empty((max_nodes, 3), np.float32)
    node_max = np.empty((max_nodes, 3), np.float32)
    prim_start = np.empty((max_nodes,), np.int32)
    prim_count = np.empty((max_nodes,), np.int32)
    skip = np.empty((max_nodes,), np.int32)
    order = np.empty((n,), np.int32)
    m = _lib().zrt_build_bvh(_fptr(lo), _fptr(hi), n, leaf_size, _fptr(node_min),
                             _fptr(node_max), _iptr(prim_start), _iptr(prim_count),
                             _iptr(skip), _iptr(order), max_nodes)
    if m < 0:
        raise RuntimeError(f"BVH build needs more than {max_nodes} nodes")
    return (node_min[:m].copy(), node_max[:m].copy(), prim_start[:m].copy(),
            prim_count[:m].copy(), skip[:m].copy(), order)


def parse_obj_native(path):
    """Parse an OBJ file: ``(vertices (V, 3) f32, triangles (T, 3) int32,
    faces, n_normals)``. A missing file raises ``FileNotFoundError``, a
    malformed face ``ObjParseError``."""
    lib = _lib()
    counts = np.zeros((4,), np.int64)
    cptr = counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
    rc = lib.zrt_parse_obj(str(path).encode(), cptr, None, None)
    if rc == -1:
        raise FileNotFoundError(path)
    if rc == -2:
        raise ObjParseError(f"malformed face in {path}")
    vertices = np.empty((int(counts[0]), 3), np.float32)
    tris = np.empty((int(counts[1]), 3), np.int32)
    rc = lib.zrt_parse_obj(str(path).encode(), cptr, _fptr(vertices), _iptr(tris))
    if rc != 0:
        raise RuntimeError(f"{path} changed while it was parsed")
    return vertices, tris, int(counts[2]), int(counts[3])
