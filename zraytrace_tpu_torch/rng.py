"""Stateless, counter-based RNG for Monte Carlo sampling.

Counterpart of ``zraytrace_tpu/rng.py``: every random number is a pure
PCG4D hash (Jarzynski & Olano, JCGT 2020) of ``(pixel, sample, bounce,
seed ^ stream)``. The streams are bit-identical to the JAX package's, so
both packages trace the same paths from the same seed.

No ``torch.Generator`` is needed anywhere on the render path: the hash
has no state to carry, so any lane can draw the numbers of any
(pixel, sample, bounce) in any order, on any device.

The JAX package's ``uniform4_i32`` has no counterpart: it restructures
``uniform4`` in int32 arithmetic because Mosaic lowers uint32 chains
about 10x slower, and draws the same numbers; the CUDA kernels hash in
``uint32_t``
(``csrc/bounce_common.cuh``).

torch has no complete uint32 arithmetic, so the hash runs on int64 holding
values in ``[0, 2^32)``, masked after every add and multiply. A multiply
is split into 16-bit halves so no intermediate leaves int64's range.
"""

from __future__ import annotations

import math

import torch

from zraytrace_tpu_torch import vecmath as vm

# Stream ids keep independent uses of the per-bounce uniforms decorrelated.
STREAM_CAMERA = 0x9E3779B9  # pixel jitter (raytrace.zig:174-175)
STREAM_SCATTER = 0x85EBCA6B  # material scatter decisions
STREAM_GENERIC = 0xC2B2AE35

_MASK = 0xFFFFFFFF
_PCG_MUL = 1664525
_PCG_INC = 1013904223


def _mul32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a * b mod 2^32`` for int64 tensors holding uint32 values."""
    lo = (a & 0xFFFF) * b
    hi = (((a >> 16) * b) & 0xFFFF) << 16
    return (lo + hi) & _MASK


def pcg4d(x, y, z, w):
    """PCG4D mix of four int64 tensors of uint32 values -> four such
    tensors. Same operation order as ``zraytrace_tpu.rng.pcg4d``."""
    x = (x * _PCG_MUL + _PCG_INC) & _MASK
    y = (y * _PCG_MUL + _PCG_INC) & _MASK
    z = (z * _PCG_MUL + _PCG_INC) & _MASK
    w = (w * _PCG_MUL + _PCG_INC) & _MASK
    x = (x + _mul32(y, w)) & _MASK
    y = (y + _mul32(z, x)) & _MASK
    z = (z + _mul32(x, y)) & _MASK
    w = (w + _mul32(y, z)) & _MASK
    x = x ^ (x >> 16)
    y = y ^ (y >> 16)
    z = z ^ (z >> 16)
    w = w ^ (w >> 16)
    x = (x + _mul32(y, w)) & _MASK
    y = (y + _mul32(z, x)) & _MASK
    z = (z + _mul32(x, y)) & _MASK
    w = (w + _mul32(y, z)) & _MASK
    return x, y, z, w


def _as_u32(v, device) -> torch.Tensor:
    """An int or integer tensor -> int64 tensor of its uint32 bits (what
    ``jnp.asarray(v, uint32)`` gives for int32 input)."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.int64) & _MASK
    return torch.tensor(int(v) & _MASK, dtype=torch.int64, device=device)


def uniform4(seed, pixel, sample, bounce, stream=STREAM_GENERIC) -> torch.Tensor:
    """Four independent U[0,1) floats per lane, shape ``(..., 4)`` f32.

    The index arguments broadcast; each is an int or an integer tensor.
    The seed is masked to 32 bits before the stream xor (``seed ^ stream``
    exceeds 2^31 and must never pass through a signed int32).
    """
    device = next(
        (a.device for a in (pixel, sample, bounce) if isinstance(a, torch.Tensor)),
        torch.device("cpu"),
    )
    p = _as_u32(pixel, device)
    s = _as_u32(sample, device)
    b = _as_u32(bounce, device)
    c = torch.tensor((int(seed) & _MASK) ^ stream, dtype=torch.int64, device=device)
    shape = torch.broadcast_shapes(p.shape, s.shape, b.shape)
    bits = pcg4d(*(t.expand(shape) for t in (p, s, b, c)))
    # top 24 bits -> [0, 1): exact in f32, as zraytrace_tpu.rng._to_unit_float
    return torch.stack(
        [(v >> 8).to(torch.float32) * (1.0 / 16777216.0) for v in bits], dim=-1
    )


def random_unit_vector(u1: torch.Tensor, u2: torch.Tensor) -> torch.Tensor:
    """Uniform random unit vector from two U[0,1) inputs: z uniform in
    [-1, 1), azimuth uniform (distribution-equivalent to sample.zig:47-62).
    """
    z = u1 * 2.0 - 1.0
    phi = (2.0 * math.pi) * u2
    r = vm.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def random_in_unit_sphere(u1: torch.Tensor, u2: torch.Tensor, u3: torch.Tensor) -> torch.Tensor:
    """Uniform point inside the unit ball from three U[0,1) inputs, with no
    rejection loop (``zraytrace_tpu/rng.py:143``; the reference rejects,
    sample.zig:22-32): a random unit direction scaled by ``cbrt(u3)``, the
    radius of the volumetric density. torch has no cube root; the f64
    power rounded to f32 is the correctly rounded one (``vecmath.sqrt``'s
    way)."""
    r = torch.pow(u3.to(torch.float64), 1.0 / 3.0).to(u3.dtype)
    return random_unit_vector(u1, u2) * r[..., None]
