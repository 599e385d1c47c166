"""Scene representation: flat, typed SoA tensors.

Counterpart of ``zraytrace_tpu/scene.py``: the same 16 fields, names,
shapes and dtypes, held as torch tensors on one device.

- spheres: centers ``(S,3)``, signed radii ``(S,)`` (a negative radius
  keeps the reference's inward-normal hollow-glass trick, sphere.zig:45),
  material ids ``(S,)``
- triangles: vertex arrays ``(T,3)`` each, material ids ``(T,)``
- materials: type/texture/ior tables (material.zig:27-29)
- textures: type/color/atlas tables (texture.zig:7-9); images live in one
  padded atlas ``(A, H, W, 3)``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

# Material type tags (material.zig:27-29).
LAMBERTIAN = 0
METAL = 1
DIELECTRIC = 2

# Texture type tags (texture.zig:7-9).
TEX_COLOR = 0
TEX_IMAGE = 1

# Named color constants (image.zig:14-20).
COLOR_BLACK = (0.0, 0.0, 0.0)
COLOR_WHITE = (1.0, 1.0, 1.0)
COLOR_GOLD = (1.0, 0.843, 0.0)
COLOR_SILVER = (0.752, 0.752, 0.752)
COLOR_RED = (1.0, 0.01, 0.01)
COLOR_GREEN = (0.01, 1.0, 0.01)
COLOR_BLUE = (0.01, 0.01, 1.0)

# Default image-texture offsets (texture.zig:15).
DEFAULT_U_OFFSET = 0.19
DEFAULT_V_OFFSET = 0.1


class Scene(NamedTuple):
    """Flat scene tensors. ``S`` spheres, ``T`` triangles, ``M`` materials,
    ``K`` textures, ``A`` atlas images."""

    sph_center: torch.Tensor  # (S, 3) f32
    sph_radius: torch.Tensor  # (S,)   f32, signed
    tri_a: torch.Tensor  # (T, 3) f32
    tri_b: torch.Tensor  # (T, 3) f32
    tri_c: torch.Tensor  # (T, 3) f32
    mat_ior: torch.Tensor  # (M,)   f32 index of refraction
    tex_color: torch.Tensor  # (K, 3) f32 constant colors
    atlas: torch.Tensor  # (A, H, W, 3) f32 padded image atlas
    sph_mat: torch.Tensor  # (S,) int32 material id per sphere
    tri_mat: torch.Tensor  # (T,) int32 material id per triangle
    mat_type: torch.Tensor  # (M,) int32 LAMBERTIAN/METAL/DIELECTRIC
    mat_tex: torch.Tensor  # (M,) int32 texture id
    tex_type: torch.Tensor  # (K,) int32 TEX_COLOR/TEX_IMAGE
    tex_image: torch.Tensor  # (K,) int32 atlas index (0 if unused)
    tex_offset: torch.Tensor  # (K, 2) f32 (u_offset, v_offset)
    atlas_hw: torch.Tensor  # (A, 2) int32 true (height, width) per image

    @property
    def n_spheres(self) -> int:
        return self.sph_center.shape[0]

    @property
    def n_triangles(self) -> int:
        return self.tri_a.shape[0]

    @property
    def n_primitives(self) -> int:
        return self.n_spheres + self.n_triangles

    def to(self, device) -> "Scene":
        return Scene(*(t.to(device) for t in self))


def mesh_materials_const(scene: Scene) -> bool:
    """True when the scene has triangles and no triangle material reads
    an image texture — true for every reference scene (meshes are single
    const-color materials, obj_reader.zig:114). Such a mesh is shaded from
    the flash planes' ``attrs`` table (``ops/flash_intersect.py``)."""
    if scene.n_triangles == 0:
        return False
    tex = scene.mat_tex[scene.tri_mat.long()].long()
    return not bool((scene.tex_type[tex] == TEX_IMAGE).any())


class SceneBuilder:
    """Host-side scene assembly in numpy (scenes.zig:26-265); ``build()``
    returns the tensor ``Scene`` on the requested device.

    Primitive insertion order is preserved: the closest-hit scan breaks
    ties by list order (raytrace.zig:75-81).
    """

    def __init__(self):
        self._sph = []  # (center, radius, mat_id)
        self._tri = []  # (a, b, c, mat_ids) blocks
        self._mats = []  # (type, tex_id, ior)
        self._texs = []  # (type, color, atlas_id, u_off, v_off)
        self._images = []  # (H, W, 3) f32 arrays

    # -- textures -------------------------------------------------------
    def add_color_texture(self, color) -> int:
        self._texs.append((TEX_COLOR, np.asarray(color, np.float32), 0, 0.0, 0.0))
        return len(self._texs) - 1

    def add_image_texture(self, image: np.ndarray,
                          u_offset: float = DEFAULT_U_OFFSET,
                          v_offset: float = DEFAULT_V_OFFSET) -> int:
        """``image`` is (H, W, 3) f32 with row 0 = image bottom
        (png_image.zig:86)."""
        image = np.asarray(image, np.float32)
        if image.ndim != 3 or image.shape[-1] != 3:
            raise ValueError(f"image must be (H, W, 3), got {image.shape}")
        self._images.append(image)
        self._texs.append((TEX_IMAGE, np.zeros(3, np.float32),
                           len(self._images) - 1, float(u_offset), float(v_offset)))
        return len(self._texs) - 1

    # -- materials ------------------------------------------------------
    def add_material(self, mat_type: int, tex_id: int = 0, ior: float = 1.0) -> int:
        self._mats.append((mat_type, tex_id, float(ior)))
        return len(self._mats) - 1

    def add_lambertian(self, tex_id: int) -> int:
        return self.add_material(LAMBERTIAN, tex_id)

    def add_metal(self, tex_id: int) -> int:
        return self.add_material(METAL, tex_id)

    def add_dielectric(self, ior: float) -> int:
        return self.add_material(DIELECTRIC, 0, ior)

    def add_lambertian_color(self, color) -> int:
        return self.add_lambertian(self.add_color_texture(color))

    def add_metal_color(self, color) -> int:
        return self.add_metal(self.add_color_texture(color))

    # -- geometry -------------------------------------------------------
    def add_sphere(self, center, radius: float, mat_id: int) -> None:
        self._sph.append((np.asarray(center, np.float32), float(radius), mat_id))

    def add_triangles(self, a: np.ndarray, b: np.ndarray, c: np.ndarray, mat_id: int) -> None:
        """Add a block of triangles sharing one material (the OBJ-model
        case: one material per model, obj_reader.zig:114)."""
        self._tri.append((np.asarray(a, np.float32), np.asarray(b, np.float32),
                          np.asarray(c, np.float32),
                          np.full((a.shape[0],), mat_id, np.int32)))

    # -- build ----------------------------------------------------------
    def build_numpy(self) -> dict[str, np.ndarray]:
        """The scene fields as numpy arrays, keyed by ``Scene`` field name."""
        S = len(self._sph)
        sph_center = np.zeros((S, 3), np.float32)
        sph_radius = np.zeros((S,), np.float32)
        sph_mat = np.zeros((S,), np.int32)
        for i, (center, radius, mid) in enumerate(self._sph):
            sph_center[i], sph_radius[i], sph_mat[i] = center, radius, mid

        if self._tri:
            tri_a, tri_b, tri_c, tri_mat = (
                np.concatenate([t[k] for t in self._tri]) for k in range(4))
        else:
            tri_a = tri_b = tri_c = np.zeros((0, 3), np.float32)
            tri_mat = np.zeros((0,), np.int32)

        M = max(len(self._mats), 1)
        mat_type = np.zeros((M,), np.int32)
        mat_tex = np.zeros((M,), np.int32)
        mat_ior = np.ones((M,), np.float32)
        for i, (mt, tid, ior) in enumerate(self._mats):
            mat_type[i], mat_tex[i], mat_ior[i] = mt, tid, ior

        K = max(len(self._texs), 1)
        tex_type = np.zeros((K,), np.int32)
        tex_color = np.zeros((K, 3), np.float32)
        tex_image = np.zeros((K,), np.int32)
        tex_offset = np.zeros((K, 2), np.float32)
        for i, (tt, col, aid, uo, vo) in enumerate(self._texs):
            tex_type[i], tex_color[i], tex_image[i] = tt, col, aid
            tex_offset[i] = (uo, vo)

        if self._images:
            max_h = max(im.shape[0] for im in self._images)
            max_w = max(im.shape[1] for im in self._images)
            atlas = np.zeros((len(self._images), max_h, max_w, 3), np.float32)
            atlas_hw = np.zeros((len(self._images), 2), np.int32)
            for i, im in enumerate(self._images):
                atlas[i, : im.shape[0], : im.shape[1]] = im
                atlas_hw[i] = (im.shape[0], im.shape[1])
        else:
            atlas = np.zeros((1, 1, 1, 3), np.float32)
            atlas_hw = np.ones((1, 2), np.int32)

        return dict(
            sph_center=sph_center, sph_radius=sph_radius,
            tri_a=tri_a, tri_b=tri_b, tri_c=tri_c,
            mat_ior=mat_ior, tex_color=tex_color, atlas=atlas,
            sph_mat=sph_mat, tri_mat=tri_mat, mat_type=mat_type,
            mat_tex=mat_tex, tex_type=tex_type, tex_image=tex_image,
            tex_offset=tex_offset, atlas_hw=atlas_hw,
        )

    def build(self, device="cuda") -> Scene:
        from zraytrace_tpu_torch.convert import scene_from_numpy

        return scene_from_numpy(self.build_numpy(), device)
