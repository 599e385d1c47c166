"""Texture lookup: constant colors and nearest-texel image lookup.

Counterpart of ``zraytrace_tpu/textures.py`` (nearest path only; the
bilinear lookup belongs to the differentiable path). Reference semantics:
texture.zig:31-74 — u-flip, u/v offsets with a single-step wrap, then a
truncating ``int`` cast and a clamp to the image. Image rows are stored
bottom-up (png_image.zig:86).
"""

from __future__ import annotations

import torch

from zraytrace_tpu_torch import scene as sc


def _wrap(x: torch.Tensor) -> torch.Tensor:
    """Single-step wrap into [0, 1] (texture.zig:54-68)."""
    x = torch.where(x > 1.0, x - 1.0, x)
    return torch.where(x < 0.0, x + 1.0, x)


def texture_albedo(scene: sc.Scene, tex_id: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Albedo at the hit point, ``(N, 3)``, for ``(N,)`` texture ids and
    ``(N, 2)`` texture coordinates."""
    tex_id = tex_id.long()
    const_color = scene.tex_color[tex_id]
    # Imageless scenes carry a (1, 1, 1, 3) dummy atlas and no TEX_IMAGE.
    if scene.atlas.shape[1] == 1 and scene.atlas.shape[2] == 1:
        return const_color
    aid = scene.tex_image[tex_id].long()
    hw = scene.atlas_hw[aid]
    h, w = hw[:, 0], hw[:, 1]
    off = scene.tex_offset[tex_id]

    uu = _wrap(1.0 - uv[:, 0] + off[:, 0])  # u flip + offset (texture.zig:54)
    vv = _wrap(uv[:, 1] + off[:, 1])
    # Truncation + clamp exactly as texture.zig:70-73.
    ix = torch.minimum(torch.clamp((uu * w.float()).to(torch.int32), min=0), w - 1)
    iy = torch.minimum(torch.clamp((vv * h.float()).to(torch.int32), min=0), h - 1)
    a_h, a_w = scene.atlas.shape[1], scene.atlas.shape[2]
    flat = aid * (a_h * a_w) + iy.long() * a_w + ix.long()
    img_color = scene.atlas.reshape(-1, 3)[flat]
    is_image = (scene.tex_type[tex_id] == sc.TEX_IMAGE)[:, None]
    return torch.where(is_image, img_color, const_color)
