"""The reference's scenes, built from a configuration's description alone.

A scene description (``configs/<name>.json``, ``scenes``) lists textures,
materials, spheres, OBJ meshes and the camera, as the Zig tracer's
``scenes.zig`` states them. This module reads the raw assets itself (its
own PNG decoder and OBJ reader) and lays the scene out its own way: the
images stay separate (no atlas), the triangles stay in file order (no
BVH, no packed planes).
"""

from __future__ import annotations

import math
import struct
import zlib
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from benchmark.reference import common as cm

LAMBERTIAN, METAL, DIELECTRIC = 0, 1, 2
MAT_TYPES = {"lambertian": LAMBERTIAN, "metal": METAL, "dielectric": DIELECTRIC}


class Camera(NamedTuple):
    origin: torch.Tensor
    lower_left: torch.Tensor
    horizontal: torch.Tensor
    vertical: torch.Tensor


class RefScene(NamedTuple):
    sph_center: torch.Tensor  # (S, 3)
    sph_radius: torch.Tensor  # (S,) signed
    sph_mat: torch.Tensor  # (S,) int64
    tri_a: torch.Tensor  # (T, 3), file order
    tri_b: torch.Tensor
    tri_c: torch.Tensor
    tri_mat: torch.Tensor  # (T,) int64
    mat_type: torch.Tensor  # (M,) int64
    mat_ior: torch.Tensor  # (M,)
    mat_tex: torch.Tensor  # (M,) int64
    tex_color: torch.Tensor  # (K, 3)
    tex_image: torch.Tensor  # (K,) int64 image index, -1 for a colour
    tex_offset: torch.Tensor  # (K, 2)
    texels: torch.Tensor  # (sum of h*w, 3): the images one after another
    img_base: torch.Tensor  # (I,) int64 first texel of each image
    img_hw: torch.Tensor  # (I, 2) int64
    camera: Camera

    @property
    def n_spheres(self) -> int:
        return self.sph_center.shape[0]

    @property
    def n_triangles(self) -> int:
        return self.tri_a.shape[0]


def _unfilter(raw: bytes, h: int, w: int, bpp: int) -> np.ndarray:
    """The PNG scanline filters undone (PNG spec section 9), one
    anti-diagonal of pixels at a time."""
    data = np.frombuffer(raw, np.uint8).reshape(h, w * bpp + 1)
    ftype = data[:, 0].astype(np.int32)
    filt = data[:, 1:].astype(np.int32).reshape(h, w, bpp)
    out = np.zeros((h + 1, w + 1, bpp), np.int32)
    rows = np.arange(h)
    for t in range(w + h - 1):
        r = rows[max(0, t - w + 1):min(h, t + 1)]
        x = t - r
        a, b, c = out[r + 1, x], out[r, x + 1], out[r, x]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        ft = ftype[r][:, None]
        pred = np.where(ft == 1, a, np.where(ft == 2, b, np.where(
            ft == 3, (a + b) >> 1, np.where(ft == 4, paeth, 0))))
        out[r + 1, x + 1] = (filt[r, x] + pred) & 255
    return out[1:, 1:].astype(np.uint8)


def read_png(path) -> np.ndarray:
    """An 8-bit RGB or RGBA PNG as ``(H, W, 3)`` float32 in [0, 1], row 0
    the image's bottom (png_image.zig:86), alpha dropped."""
    data = Path(path).read_bytes()
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, payload = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif kind == b"IDAT":
            idat.append(payload)
        elif kind == b"IEND":
            break
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in (2, 6) or interlace:
        raise ValueError(f"{path}: only 8-bit non-interlaced RGB or RGBA PNGs")
    px = _unfilter(zlib.decompress(b"".join(idat)), h, w, 3 if ctype == 2 else 4)
    return (px[..., :3].astype(np.float32) / 255.0)[::-1].copy()


_FAN = ((0, 1, 2), (2, 3, 0), (3, 4, 0), (4, 5, 0))


def read_obj(path) -> tuple:
    """An OBJ's triangles ``(a, b, c)``, each ``(T, 3)`` float32: ``v``
    records, ``f`` records of 3 to 6 vertices fanned as obj_reader.zig
    does (0 1 2, 2 3 0, 3 4 0, 4 5 0), 1-based indices before any ``/``."""
    verts, tris = [], []
    for line in Path(path).read_text().splitlines():
        if line.startswith("v "):
            verts.append(line[2:].split()[:3])
        elif line.startswith("f "):
            idx = [int(tok.split("/")[0]) - 1 for tok in line[2:].split()]
            if not 3 <= len(idx) <= 6:
                raise ValueError(f"{path}: a face of {len(idx)} vertices")
            tris.extend([idx[i] for i in fan] for fan in _FAN[:len(idx) - 2])
    v = np.array(verts, dtype=np.float32)[np.array(tris, dtype=np.int64)]
    return v[:, 0], v[:, 1], v[:, 2]


def make_camera(cam: dict) -> Camera:
    """camera.zig:17-45 in float32 on the host: the frame of a pinhole
    camera with no aperture."""
    f32 = lambda v: torch.as_tensor(np.asarray(v, np.float32))
    look_from, look_at, vup = f32(cam["look_from"]), f32(cam["look_at"]), f32(cam["vup"])
    theta = f32(math.pi * cam["vfov"] / 180.0)
    h = torch.tan(theta / 2.0)
    vh = 2.0 * h
    vw = cam["aspect"] * vh
    w = cm.normalize(look_from - look_at)
    u = cm.normalize(torch.linalg.cross(vup, w))
    v = torch.linalg.cross(w, u)
    horizontal, vertical = u * vw, v * vh
    return Camera(look_from, look_from - horizontal * 0.5 - vertical * 0.5 - w, horizontal,
                  vertical)


def build(desc: dict, root: Path, device, dtype=torch.float32) -> RefScene:
    """The scene ``desc`` describes, its asset paths relative to ``root``,
    on ``device`` with its floats in ``dtype``."""
    fl = lambda x: np.asarray(x, np.float32)
    images, tex_image, tex_color, tex_offset = [], [], [], []
    for t in desc["textures"]:
        if "image" in t:
            tex_image.append(len(images))
            images.append(read_png(root / t["image"]))
            tex_color.append((0.0, 0.0, 0.0))
            tex_offset.append(t["offset"])
        else:
            tex_image.append(-1)
            tex_color.append(t["color"])
            tex_offset.append((0.0, 0.0))
    if not images:
        images = [np.zeros((1, 1, 3), np.float32)]
    img_hw = [im.shape[:2] for im in images]
    img_base = np.cumsum([0] + [h * w for h, w in img_hw])[:-1]
    texels = np.concatenate([im.reshape(-1, 3) for im in images])

    mats = desc["materials"]
    spheres = desc["spheres"]
    tris = [[], [], [], []]
    for m in desc.get("meshes", []):
        a, b, c = read_obj(root / m["obj"])
        for k, x in enumerate((a, b, c)):
            tris[k].append(x)
        tris[3].append(np.full(a.shape[0], m["material"], np.int64))
    if tris[0]:
        tri_a, tri_b, tri_c = (np.concatenate(x) for x in tris[:3])
        tri_mat = np.concatenate(tris[3])
    else:
        tri_a = tri_b = tri_c = np.zeros((0, 3), np.float32)
        tri_mat = np.zeros((0,), np.int64)

    cam = make_camera(desc["camera"])
    to_f = lambda x: torch.as_tensor(x).to(device=device, dtype=dtype)
    to_i = lambda x: torch.as_tensor(np.asarray(x, np.int64)).to(device)
    return RefScene(
        sph_center=to_f(fl([s["center"] for s in spheres])),
        sph_radius=to_f(fl([s["radius"] for s in spheres])),
        sph_mat=to_i([s["material"] for s in spheres]),
        tri_a=to_f(tri_a), tri_b=to_f(tri_b), tri_c=to_f(tri_c), tri_mat=to_i(tri_mat),
        mat_type=to_i([MAT_TYPES[m["type"]] for m in mats]),
        mat_ior=to_f(fl([m.get("ior", 1.0) for m in mats])),
        mat_tex=to_i([m.get("texture", 0) for m in mats]),
        tex_color=to_f(fl(tex_color)), tex_image=to_i(tex_image), tex_offset=to_f(fl(tex_offset)),
        texels=to_f(texels), img_base=to_i(img_base), img_hw=to_i(img_hw),
        camera=Camera(*(to_f(x) for x in cam)))
