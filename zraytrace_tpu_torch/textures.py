"""Texture lookup: constant colors, and nearest or bilinear image lookup.

Counterpart of ``zraytrace_tpu/textures.py``. Reference semantics:
texture.zig:31-74 — u-flip, u/v offsets with a single-step wrap, then a
truncating ``int`` cast and a clamp to the image. Image rows are stored
bottom-up (png_image.zig:86). The bilinear lookup is the differentiable
path's: nearest texels have no gradient with respect to the hit point.
"""

from __future__ import annotations

import torch

from zraytrace_tpu_torch import scene as sc


def _wrap(x: torch.Tensor) -> torch.Tensor:
    """Single-step wrap into [0, 1] (texture.zig:54-68)."""
    x = torch.where(x > 1.0, x - 1.0, x)
    return torch.where(x < 0.0, x + 1.0, x)


def texture_albedo(scene: sc.Scene, tex_id: torch.Tensor, uv: torch.Tensor,
                   bilinear: bool = False) -> torch.Tensor:
    """Albedo at the hit point, ``(N, 3)``, for ``(N,)`` texture ids and
    ``(N, 2)`` texture coordinates. ``bilinear`` interpolates the four
    texels around the point (``zraytrace_tpu/textures.py:124-156``), so
    gradients reach ``uv``, ``atlas`` and ``tex_color``; off, the
    reference's nearest texel."""
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
    a_h, a_w = scene.atlas.shape[1], scene.atlas.shape[2]
    base = aid * (a_h * a_w)
    flat_atlas = scene.atlas.reshape(-1, 3)
    if bilinear:
        wf, hf = w.to(torch.float32), h.to(torch.float32)
        fx = uu * wf - 0.5
        fy = vv * hf - 0.5
        x0 = torch.floor(fx)
        y0 = torch.floor(fy)
        tx = (fx - x0)[:, None]
        ty = (fy - y0)[:, None]
        # one (N, 4) gather, so the atlas adjoint is one scatter-add; each
        # tap keeps the association (c * weight_x) * weight_y
        xs = torch.stack([x0, x0 + 1.0, x0, x0 + 1.0], dim=1)
        ys = torch.stack([y0, y0, y0 + 1.0, y0 + 1.0], dim=1)
        xi = torch.minimum(torch.clamp(xs, min=0.0), (wf - 1.0)[:, None]).to(torch.int32)
        yi = torch.minimum(torch.clamp(ys, min=0.0), (hf - 1.0)[:, None]).to(torch.int32)
        flat4 = base[:, None] + yi.long() * a_w + xi.long()
        c = flat_atlas[flat4.reshape(-1)].reshape(flat4.shape + (3,))
        img_color = (c[:, 0] * (1 - tx) * (1 - ty) + c[:, 1] * tx * (1 - ty)
                     + c[:, 2] * (1 - tx) * ty + c[:, 3] * tx * ty)
    else:
        # Truncation + clamp exactly as texture.zig:70-73.
        ix = torch.minimum(torch.clamp((uu * w.float()).to(torch.int32), min=0), w - 1)
        iy = torch.minimum(torch.clamp((vv * h.float()).to(torch.int32), min=0), h - 1)
        img_color = flat_atlas[base + iy.long() * a_w + ix.long()]
    is_image = (scene.tex_type[tex_id] == sc.TEX_IMAGE)[:, None]
    return torch.where(is_image, img_color, const_color)
