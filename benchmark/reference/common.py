"""The reference's plain arithmetic: the PCG4D streams and vector algebra.

Written out from the published semantics (PCG4D, Jarzynski & Olano, JCGT
2020; the Zig tracer's vector.zig) in plain PyTorch, in the operation
order the traced program's documentation fixes: dot products as
``(x*x' + y*y') + z*z'``, square roots and divisions correctly rounded.
Every float function takes its tensors in one dtype, float32 for the
reference and bfloat16 for the control, so the same code gives both.
"""

from __future__ import annotations

import math

import torch

STREAM_CAMERA = 0x9E3779B9
STREAM_SCATTER = 0x85EBCA6B
MASK = 0xFFFFFFFF
_PCG_MUL = 1664525
_PCG_INC = 1013904223


def big(dtype) -> float:
    """The "no hit" distance: 3.4e38 where the dtype holds it (float32),
    else the dtype's largest value."""
    return min(3.4e38, torch.finfo(dtype).max)


def _mul32(a, b):
    lo = (a & 0xFFFF) * b
    hi = (((a >> 16) * b) & 0xFFFF) << 16
    return (lo + hi) & MASK


def pcg4d(x, y, z, w):
    """PCG4D on int64 tensors holding uint32 values."""
    x = (x * _PCG_MUL + _PCG_INC) & MASK
    y = (y * _PCG_MUL + _PCG_INC) & MASK
    z = (z * _PCG_MUL + _PCG_INC) & MASK
    w = (w * _PCG_MUL + _PCG_INC) & MASK
    for _ in range(2):
        x = (x + _mul32(y, w)) & MASK
        y = (y + _mul32(z, x)) & MASK
        z = (z + _mul32(x, y)) & MASK
        w = (w + _mul32(y, z)) & MASK
        if _ == 0:
            x, y, z, w = x ^ (x >> 16), y ^ (y >> 16), z ^ (z >> 16), w ^ (w >> 16)
    return x, y, z, w


def uniform4(seed: int, pixel, sample, bounce, stream: int, dtype) -> torch.Tensor:
    """Four U[0,1) numbers per lane ``(..., 4)``: the top 24 bits of each
    PCG4D word of ``(pixel, sample, bounce, (seed mod 2^32) ^ stream)``."""
    dev = pixel.device
    as64 = lambda v: (v.to(torch.int64) if isinstance(v, torch.Tensor)
                      else torch.tensor(int(v), dtype=torch.int64, device=dev)) & MASK
    p, s, b = as64(pixel), as64(sample), as64(bounce)
    c = torch.tensor((int(seed) & MASK) ^ stream, dtype=torch.int64, device=dev)
    shape = torch.broadcast_shapes(p.shape, s.shape, b.shape)
    bits = pcg4d(*(t.expand(shape) for t in (p, s, b, c)))
    out = torch.stack([(v >> 8).to(torch.float32) * (1.0 / 16777216.0) for v in bits], dim=-1)
    return out.to(dtype)


def dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross(a, b):
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1)


def sqrt(x):
    """Correctly rounded square root: through float64."""
    return torch.sqrt(x.to(torch.float64)).to(x.dtype)


def div(x, s: float):
    """``x / s`` as a true division by a tensor (not a reciprocal)."""
    return x / torch.full((), s, dtype=x.dtype, device=x.device)


def normalize(v):
    return v / sqrt(dot(v, v))[..., None]


def normalize_safe(v, eps: float = 1e-20):
    n2 = dot(v, v)
    ok = n2 > eps
    one = torch.ones((), dtype=n2.dtype, device=n2.device)
    inv = torch.where(ok, 1.0 / sqrt(torch.where(ok, n2, one)), 0.0)
    return v * inv[..., None]


def reflect(v, n):
    return v - 2.0 * dot(v, n)[..., None] * n


def refract(v, n, ratio):
    ratio = ratio[..., None]
    cos_theta = torch.clamp(dot(-v, n), max=1.0)[..., None]
    r_out_perp = ratio * (v + cos_theta * n)
    k = torch.abs(1.0 - dot(r_out_perp, r_out_perp))
    pos = k > 0.0
    one = torch.ones((), dtype=k.dtype, device=k.device)
    root = torch.where(pos, sqrt(torch.where(pos, k, one)), 0.0)
    return r_out_perp + (-root[..., None] * n)


def sky(d):
    """The only light: the sky gradient seen along unit ``d``."""
    t = 0.5 * (d[..., 1] + 1.0)
    white = torch.tensor([1.0, 1.0, 1.0], dtype=d.dtype, device=d.device)
    blue = torch.tensor([0.5, 0.7, 1.0], dtype=d.dtype, device=d.device)
    return (1.0 - t)[..., None] * white + t[..., None] * blue


def random_unit_vector(u1, u2):
    z = u1 * 2.0 - 1.0
    phi = (2.0 * math.pi) * u2
    r = sqrt(torch.clamp(1.0 - z * z, min=0.0))
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)
