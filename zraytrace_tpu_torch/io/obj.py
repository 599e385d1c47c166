"""Wavefront OBJ reader -> triangle vertex arrays; counterpart of
``zraytrace_tpu/io/obj.py``.

Reference semantics: obj_reader.zig — ``v`` vertices
(obj_reader.zig:151-159), ``f`` faces of 3..6 vertices fan-triangulated
in the exact pattern {0,1,2} {2,3,0} {3,4,0} {4,5,0}
(obj_reader.zig:64-111), ``vn`` collected but never used
(obj_reader.zig:176-184). Face vertex tokens may be ``v``, ``v/t``,
``v/t/n`` or ``v//n`` with 1-based indices (obj_reader.zig:21-60). One
material per model (obj_reader.zig:114). Faces with fewer than 3 or more
than 6 vertices raise ``ObjParseError``.

``read_obj`` parses with the port's C++ parser (``native/obj_parser.cpp``).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from zraytrace_tpu_torch.native.api import ObjParseError, parse_obj_native
from zraytrace_tpu_torch.profiling import span

__all__ = ["ObjModel", "ObjParseError", "read_obj"]


@dataclasses.dataclass
class ObjModel:
    vertices: np.ndarray  # (V, 3) f32
    faces: int  # number of 'f' records
    triangles: np.ndarray  # (T, 3) int32 vertex indices (0-based)
    n_normals: int  # number of 'vn' records (counted, never used)

    @property
    def tri_vertices(self):
        """Triangle vertex arrays ``(a, b, c)``, each ``(T, 3)`` f32."""
        v = self.vertices[self.triangles]
        return v[:, 0], v[:, 1], v[:, 2]


@span("io.obj")
def read_obj(path) -> ObjModel:
    vertices, tris, faces, n_normals = parse_obj_native(path)
    return ObjModel(vertices=vertices, faces=faces, triangles=tris, n_normals=n_normals)
