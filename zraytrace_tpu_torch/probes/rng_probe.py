"""What do PCG4D's 32-bit integer multiplies cost on the card?

Counterpart of ``tools/rng_probe.py`` (its kernel ``build``, :196-216):
``(R_TOT, L) = (1024, 128)`` int32 lanes, ``B = 8`` iterations of
``c = c + fn(c, i)`` per launch, one variant ``fn`` per line (``VARIANTS``,
the tool's :188-193). The kernel, with the note on what bounds it and how
each TPU variant maps to the card, is ``csrc/probe_rng.cu``.

``rng_chain`` launches the kernel for a CUDA tensor and runs
``rng_chain_plain`` for a CPU tensor. The plain version computes in int64
holding int32 values, wrapped to 32 bits after every add, multiply and
left shift; the uint32 PCG4D comes from the port's ``rng.pcg4d``.

    python -m zraytrace_tpu_torch.probes.rng_probe [--cpu] [variant ...]
"""

from __future__ import annotations

import ctypes
import sys

import numpy as np
import torch

from zraytrace_tpu_torch import rng as zrng
from zraytrace_tpu_torch.probes import common

__all__ = ["VARIANTS", "LAUNCHES", "R_TOT", "L", "B", "K", "rng_chain", "rng_chain_plain",
           "make_input", "self_check", "measure", "PCG4D_I32_INT_OPS"]

R_TOT, L = 1024, 128
B = 8  # in-kernel iterations per launch
K = 24  # launches chained for timing
VARIANTS = ("u32mul", "u32mulvar", "i32mul", "i32mulvar", "f32mul", "shifts", "pcg4d",
            "pcg4d_i32", "pcg4d_16b", "threefry13")

# Kernel launches made by ``rng_chain`` in this process.
LAUNCHES = 0

_M32 = 0xFFFFFFFF
_PCG_M, _PCG_A = 1664525, 1013904223


def _w(v):
    """Wrap int64 values to the int32 they hold (two's complement)."""
    return ((v + 2**31) & _M32) - 2**31


def _u(v):
    """The uint32 bits of an int32 value held in int64."""
    return v & _M32


def _v_u32mul(x, i):
    u = _u(x)
    for _ in range(10):
        u = _u(u * 1664525)
    return _w(u)


def _v_u32mulvar(x, i):
    # the low 32 bits of a product are the same for the signed and the
    # unsigned reading, so the uint32 chain runs on wrapped int32 values
    u = x
    v = x ^ _w(0x9E3779B9)
    for _ in range(5):
        u = _w(u * v)
        v = _w(v + u)
    return u


def _v_i32mul(x, i):
    u = x
    for _ in range(10):
        u = _w(u * 1664525)
    return u


def _v_i32mulvar(x, i):
    u = x
    v = x ^ 0x1E377909
    for _ in range(5):
        u = _w(u * v)
        v = _w(v + u)
    return u


def _v_f32mul(x, i):
    u = x.to(torch.float32)
    f = torch.full((), 1.0001, dtype=torch.float32, device=x.device)
    for _ in range(10):
        u = u * f
    return u.to(torch.int32).to(torch.int64)


def _v_shifts(x, i):
    u = x
    for _ in range(10):
        u = u ^ ((u >> 13) & 0x7FFFF)
        u = _w(u + _w(u << 7))
    return u


def _pcg4d_u32(px, sa, dp, sd):
    """The port's uint32 PCG4D (``rng.pcg4d``): the first hash's top 24 bits."""
    return zrng.pcg4d(_u(px), _u(sa), _u(dp), _u(sd))[0] >> 8


def _v_pcg4d(x, i):
    return _w(_pcg4d_u32(x, _w(x + 1), _w(x + i), torch.full_like(x, 42))
              + _pcg4d_u32(_w(x + 2), _w(x + 3), _w(x + i), torch.full_like(x, 7)))


def _rsh16(v):
    return (v >> 16) & 0xFFFF


def _pcg4d_i32(px, sa, dp, sd, mul=lambda a, b: _w(a * b)):
    """PCG4D in int32 arithmetic (the tool's ``_pcg4d_i32``), bit-identical
    to the uint32 form: mul and add wrap the same, logical shifts by masking."""
    x = _w(mul(px, _PCG_M) + _PCG_A)
    y = _w(mul(sa, _PCG_M) + _PCG_A)
    z = _w(mul(dp, _PCG_M) + _PCG_A)
    w = _w(mul(sd, _PCG_M) + _PCG_A)
    x = _w(x + mul(y, w))
    y = _w(y + mul(z, x))
    z = _w(z + mul(x, y))
    w = _w(w + mul(y, z))
    x = x ^ _rsh16(x)
    y = y ^ _rsh16(y)
    z = z ^ _rsh16(z)
    w = w ^ _rsh16(w)
    x = _w(x + mul(y, w))
    y = _w(y + mul(z, x))
    z = _w(z + mul(x, y))
    w = _w(w + mul(y, z))
    return (x >> 8) & 0xFFFFFF


def _v_pcg4d_i32(x, i):
    return _w(_pcg4d_i32(x, _w(x + 1), _w(x + i), torch.full_like(x, 42))
              + _pcg4d_i32(_w(x + 2), _w(x + 3), _w(x + i), torch.full_like(x, 7)))


def _mul16(a, b):
    """The low 32 bits of ``a * b`` from 16-bit halves (the tool's ``_mul_i32``)."""
    a_lo, a_hi = a & 0xFFFF, (a >> 16) & 0xFFFF
    b_lo, b_hi = b & 0xFFFF, (b >> 16) & 0xFFFF
    return _w(a_lo * b_lo + ((a_lo * b_hi + a_hi * b_lo) << 16))


def _v_pcg4d_16b(x, i):
    sd = torch.full_like(x, 42)
    return _w(_pcg4d_i32(x, _w(x + 1), _w(x + i), sd, _mul16)
              + _pcg4d_i32(_w(x + 2), _w(x + 3), _w(x + i), sd, _mul16))


_ROT = (13, 15, 26, 6, 17, 29, 16, 24)


def _rotl(v, r):
    """The tool's rotate, its mask included."""
    return _w(v << r) | ((v >> (32 - r)) & ((1 << (32 - r)) - 1))


def _threefry13(k0, k1, c0, c1):
    ks2 = k0 ^ k1 ^ 0x1BD11BDA
    keys = (k0, k1, ks2)
    x0 = _w(c0 + k0)
    x1 = _w(c1 + k1)
    for r in range(13):
        x0 = _w(x0 + x1)
        x1 = _rotl(x1, _ROT[r % 8]) ^ x0
        if r % 4 == 3:
            j = r // 4 + 1
            x0 = _w(x0 + keys[j % 3])
            x1 = _w(x1 + keys[(j + 1) % 3] + j)
    return x0


def _v_threefry13(x, i):
    sd = torch.full_like(x, 42)
    return _w(_threefry13(x, _w(x + i), sd, _w(x + 1))
              + _threefry13(_w(x + 2), _w(x + i), sd, _w(x + 3)))


_PLAIN = dict(u32mul=_v_u32mul, u32mulvar=_v_u32mulvar, i32mul=_v_i32mul,
              i32mulvar=_v_i32mulvar, f32mul=_v_f32mul, shifts=_v_shifts, pcg4d=_v_pcg4d,
              pcg4d_i32=_v_pcg4d_i32, pcg4d_16b=_v_pcg4d_16b, threefry13=_v_threefry13)


def rng_chain_plain(x: torch.Tensor, variant: str, iters: int = B) -> torch.Tensor:
    """``iters`` iterations of ``c = c + fn(c, i)`` from int32 ``x``."""
    fn = _PLAIN[variant]
    c = x.to(torch.int64)
    for i in range(iters):
        c = _w(c + fn(c, i))
    return c.to(torch.int32)


def rng_chain(x: torch.Tensor, variant: str, iters: int = B, chain: int = 1) -> torch.Tensor:
    """One launch of the probe kernel (``chain`` chained launches folded
    into it) on a CUDA tensor; the plain version on a CPU tensor."""
    global LAUNCHES
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}")
    if x.dtype != torch.int32:
        raise ValueError("x must be int32")
    if x.device.type == "cpu":
        c = x
        for _ in range(chain):
            c = rng_chain_plain(c, variant, iters)
        return c
    if x.device.type != "cuda":
        raise ValueError(f"rng_chain runs on cpu or cuda tensors, not {x.device.type}")
    if iters < 0 or chain < 0 or x.numel() >= 1 << 31:
        raise ValueError("iters and chain must be >= 0 and x must have < 2^31 lanes")
    x = x.contiguous()
    out = torch.empty_like(x)
    _P, _I = ctypes.c_void_p, ctypes.c_int
    fn = common.bind("probe_rng", "zr_probe_rng_launch", [_I, _P, _P, _I, _I, _I, _P])
    with torch.cuda.device(x.device):
        common.launch("probe_rng", fn, VARIANTS.index(variant), x.data_ptr(), out.data_ptr(),
                      x.numel(), iters, chain)
    LAUNCHES += 1
    return out


def make_input(device, shape=(R_TOT, L), seed: int = 0) -> torch.Tensor:
    """The tool's lanes: int32 in [0, 2^20) from numpy's generator. The
    tool draws its 64 self-check counters first from the same generator."""
    rng = np.random.default_rng(seed)
    rng.integers(0, 2**32, (64,), dtype=np.uint32)
    return torch.from_numpy(rng.integers(0, 1 << 20, shape).astype(np.int32)).to(device)


def self_check(device, n: int = 64, seed: int = 0) -> None:
    """The tool's check (:220-232): the int32 PCG4D is bit-exact against
    the port's uint32 ``rng.pcg4d``, on counters across the whole range."""
    a = np.random.default_rng(seed).integers(0, 2**32, (n,), dtype=np.uint32)
    a64 = torch.from_numpy(a.astype(np.int64)).to(device)
    ref = zrng.pcg4d(a64, _u(a64 + 1), _u(a64 + 2), torch.full_like(a64, 42))[0] >> 8
    ai = _w(a64)
    got = _pcg4d_i32(ai, _w(ai + 1), _w(ai + 2), torch.full_like(ai, 42))
    if not torch.equal(ref, got):
        raise common.ProbeMismatch("rng_probe: the int32 PCG4D differs from the uint32 one")


# Integer operations per lane and iteration, counted from csrc/probe_rng.cu
# as written (adds, multiplies, shifts, ands, xors; no constant folding):
# one int32 PCG4D 38 (four seeds 8, two mixing rounds 16, the xor-shifts
# 12, the output shift and mask 2), its four argument adds and the two
# sums.
PCG4D_I32_INT_OPS = 2 * 38 + 4 + 2


def measure(device, variants=VARIANTS) -> list[dict]:
    """One row per variant (see ``probes.common``). On the card the
    kernel's single launch must equal the plain version bit for bit; its
    time is that of K chained launches folded into one, per launch."""
    x = make_input(device)
    self_check(device)
    n = x.numel()
    rows = []
    for name in variants:
        plain, plain_ms = common.time_ms(lambda: rng_chain_plain(x, name), device, repeats=1)
        row = dict(probe="rng_probe", variant=name, device=str(device), plain_ms=plain_ms,
                   ms=None, per=None, unit="ns/lane", max_abs_err=None)
        if device.type == "cuda":
            got = rng_chain(x, name)
            row["max_abs_err"] = common.compare(f"rng_probe {name}", got, plain)
            _, ms = common.time_ms(lambda: rng_chain(x, name, chain=K), device)
            row["ms"] = ms / K
            row["per"] = row["ms"] / (B * n) * 1e6
        rows.append(row)
    return rows


if __name__ == "__main__":
    sys.exit(common.main_for(measure, VARIANTS, sys.argv[1:]))
