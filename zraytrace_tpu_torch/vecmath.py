"""Batched 3D vector math over ``(..., 3)`` tensors.

Counterpart of ``zraytrace_tpu/vecmath.py``. Every dot product is written
as an explicit component sum ``(x*x' + y*y') + z*z'`` — the order the JAX
reference's three-element reductions use — rather than ``@`` or
``sum(-1)``, whose summation order differs across backends. Event counters
are compared bit-exactly against the reference, so a flipped rounding in a
near-grazing hit test would show up as a counter difference.
"""

from __future__ import annotations

import torch


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched dot product (vector.zig:65). Returns shape ``(...,)``."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched cross product (vector.zig:70), each component a difference
    of two separately rounded products. (XLA's CPU backend contracts
    ``a1*b2 - a2*b1`` into ``fma(a1, b2, -(a2*b1))``, so the JAX
    function can differ from this in the last bit.)"""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1)


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 square root on every device. torch's CPU
    ``sqrt`` on float32 is a vectorized approximation that is off by one
    ulp for about 1 input in 150, where XLA and CUDA's ``sqrtf`` round
    exactly; the f64 square root rounded to f32 is exact."""
    return torch.sqrt(x.to(torch.float64)).to(x.dtype)


def div(x: torch.Tensor, s: float) -> torch.Tensor:
    """``x / s`` for a Python number ``s``, correctly rounded on every
    device. On CUDA, torch divides by a host scalar by multiplying with
    its reciprocal, which is off by an ulp for some inputs; dividing by a
    tensor on ``x``'s device is a true division, as in XLA and the CUDA
    kernel."""
    return x / torch.full((), s, dtype=x.dtype, device=x.device)


def length_squared(v: torch.Tensor) -> torch.Tensor:
    return dot(v, v)


def length(v: torch.Tensor) -> torch.Tensor:
    return sqrt(length_squared(v))


def normalize(v: torch.Tensor) -> torch.Tensor:
    """Unit vector (vector.zig:88): divides by the length, like the
    reference (not a multiply by ``rsqrt``). Zero input yields NaNs."""
    return v / length(v)[..., None]


def normalize_safe(v: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    """Unit vector that returns 0 for (near-)zero input instead of NaN.

    Computed as ``v * (1 / sqrt(|v|^2))``, as the CUDA kernel does. The
    JAX reference multiplies by ``lax.rsqrt``, which XLA's CPU backend
    approximates (off by an ulp for most inputs), so directions may differ
    from the reference's in the last bit. The double-where keeps masked
    lanes finite.
    """
    n2 = length_squared(v)
    ok = n2 > eps
    one = torch.ones((), dtype=n2.dtype, device=n2.device)
    inv = torch.where(ok, 1.0 / sqrt(torch.where(ok, n2, one)), 0.0)
    return v * inv[..., None]


def reflect(v: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Mirror reflection (vector.zig:129): ``v - 2 (v.n) n``."""
    return v - 2.0 * dot(v, n)[..., None] * n


def refract(v: torch.Tensor, n: torch.Tensor, ratio: torch.Tensor) -> torch.Tensor:
    """Snell refraction (vector.zig:134-139), ``ratio`` = n1/n2 per lane.

    ``|1 - |perp|^2|`` rounds to exactly 0 for grazing rays; the
    double-where keeps ``sqrt`` away from the masked lanes.
    """
    ratio = ratio[..., None]
    cos_theta = torch.clamp(dot(-v, n), max=1.0)[..., None]
    r_out_perp = ratio * (v + cos_theta * n)
    k = torch.abs(1.0 - length_squared(r_out_perp))
    pos = k > 0.0
    one = torch.ones((), dtype=k.dtype, device=k.device)
    root = torch.where(pos, sqrt(torch.where(pos, k, one)), 0.0)
    r_out_parallel = -root[..., None] * n
    return r_out_perp + r_out_parallel


def ray_at(origin: torch.Tensor, direction: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """P(t) = O + t D (ray.zig:14)."""
    return origin + t[..., None] * direction
