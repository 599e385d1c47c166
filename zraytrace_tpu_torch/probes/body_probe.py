"""Which slice of the bounce body costs the most on the card?

Counterpart of ``tools/body_probe.py`` (its kernel ``build``, :337-372):
15 ``(1024, 128)`` lane planes (12 f32: origin, direction, throughput,
radiance; 3 int32: depth, sample, slot) and a base-pixel plane, ``B = 8``
iterations of a body per launch, scene 1's tables (7 spheres, 5
materials, the camera) and the tool's integer parameters. The bodies
(``VARIANTS``) are the tool's seven slices (:247-334): ``pass_`` (no
work), ``spheres`` (the fused sphere winner), ``rng`` (two PCG4D draws),
``trig`` (the polynomial acos/atan2 and a sin and cos), ``intdiv``
(pixel % width, pixel // width), ``mats`` (eleven material-table
selects) and ``full`` (the whole segment body, ``body_full`` :40-244).
``trig_libdevice`` is ``trig`` with CUDA's own ``acosf``/``atan2f``, the
form the port's bounce kernel runs (``csrc/bounce_kernel.cu``).

The kernel, with its note, is ``csrc/probe_body.cu``; its PCG4D and
sphere winner are the bounce kernel's own device functions
(``csrc/bounce_common.cuh``). ``body_chain`` launches it for CUDA
tensors and runs ``body_chain_plain`` for CPU tensors. The polynomial
``_acos``/``_atan2`` are this module's copy of
``zraytrace_tpu/ops/common.py:76-107``. The kernel takes its divisions,
square roots, reciprocals, sinf and cosf from ``csrc/exact_math.cuh``'s
fast paths; ``math_check`` holds those to CUDA's own functions on the
card, bit for bit.

    python -m zraytrace_tpu_torch.probes.body_probe [--cpu] [variant ...]
"""

from __future__ import annotations

import ctypes
import sys

import numpy as np
import torch

from zraytrace_tpu_torch import rng as zrng
from zraytrace_tpu_torch import vecmath as vm
from zraytrace_tpu_torch.ops.bounce_kernel import scene_tables, sphere_rows
from zraytrace_tpu_torch.probes import common
from zraytrace_tpu_torch.scenes import three_balls

__all__ = ["VARIANTS", "LAUNCHES", "R_TOT", "L", "B", "K", "N_F32", "N_I32", "MATH_CHECKS",
           "body_chain", "body_chain_plain", "make_inputs", "measure", "full_ops",
           "full_bytes", "full_instructions", "math_check"]

R_TOT, L = 1024, 128
B = 8  # body iterations per launch
K = 24  # launches chained for timing
N_F32, N_I32 = 12, 3  # lane planes
VARIANTS = ("pass_", "spheres", "rng", "trig", "intdiv", "mats", "full", "trig_libdevice")

# Kernel launches made by ``body_chain`` in this process.
LAUNCHES = 0

BIG = 3.4e38
T_MIN = 1e-3
_PI = float(np.float32(np.pi))
# integer parameter slots (zraytrace_tpu/ops/common.py P_*)
(P_WIDTH, P_HEIGHT, P_SEND, P_MAXDEPTH, P_SEED, P_NPIX, P_STRIDE, P_SSTART, P_ATLASW,
 P_NSLOTS) = range(10)


def _dot(ax, ay, az, bx, by, bz):
    return ax * bx + ay * by + az * bz


def _normalize(x, y, z):
    """Multiply by 1 / sqrt(|v|^2), as the kernel does (the tool multiplies
    by ``rsqrt``, which XLA approximates on the CPU)."""
    inv = 1.0 / vm.sqrt(x * x + y * y + z * z)
    return x * inv, y * inv, z * inv


def _atan_core(z):
    """atan for |z| <= 1, Cephes atanf's minimax polynomial."""
    z2 = z * z
    p = torch.full_like(z, float(np.float32(8.05374449538e-2)))
    p = p * z2 - float(np.float32(1.38776856032e-1))
    p = p * z2 + float(np.float32(1.99777106478e-1))
    p = p * z2 - float(np.float32(3.33329491539e-1))
    return p * z2 * z + z


def _atan2(y, x):
    """atan2 from the polynomial core (ops/common.py:86-100)."""
    ax, ay = x.abs(), y.abs()
    big = ay > ax
    num = torch.where(big, ax, ay)
    den = torch.where(big, ay, ax)
    den = torch.where(den > 0.0, den, 1.0)
    a = _atan_core(num / den)
    a = torch.where(big, float(np.float32(np.pi / 2)) - a, a)
    a = torch.where(x < 0.0, _PI - a, a)
    return torch.where(y < 0.0, -a, a)


def _acos(x):
    """acos via atan2(sqrt(1 - x^2), x); |x| < 1 (callers clip)."""
    return _atan2(vm.sqrt(torch.clamp((1.0 - x) * (1.0 + x), min=0.0)), x)


def _floordiv(a, b):
    return torch.div(a, b, rounding_mode="floor")


def _sphere_winner(o, d, sph):
    """The fused winner over the sphere rows: (t_best, cx, cy, cz, r, mat).
    Each test reads c.c - r^2 from the winner's rows, as the kernel does
    (``sphere_rows``)."""
    ox, oy, oz = o
    dx, dy, dz = d
    o_dot_d = _dot(ox, oy, oz, dx, dy, dz)
    o_sq = _dot(ox, oy, oz, ox, oy, oz)
    t_best = torch.full_like(ox, BIG)
    cxs, cys, czs = torch.zeros_like(ox), torch.zeros_like(ox), torch.zeros_like(ox)
    rs = torch.ones_like(ox)
    ms = torch.zeros(ox.shape, dtype=torch.int32, device=ox.device)
    rows = sphere_rows(sph)
    for s in range(sph.shape[0]):
        cx, cy, cz, r = sph[s, 0], sph[s, 1], sph[s, 2], sph[s, 3]
        mid = int(sph[s, 4])
        half_b = o_dot_d - (dx * cx + dy * cy + dz * cz)
        cc = o_sq - 2.0 * (ox * cx + oy * cy + oz * cz) + rows[s, 3]
        disc = half_b * half_b - cc
        pos = disc > 0.0
        root = torch.where(pos, vm.sqrt(torch.where(pos, disc, 1.0)), 0.0)
        t1 = -half_b - root
        t2 = -half_b + root
        ok1 = (t1 > T_MIN) & (t1 < BIG)
        ok2 = (t2 > T_MIN) & (t2 < BIG)
        t = torch.where(ok1, t1, t2)
        better = (disc >= 0.0) & (ok1 | ok2) & (t < t_best)
        t_best = torch.where(better, t, t_best)
        cxs = torch.where(better, cx, cxs)
        cys = torch.where(better, cy, cys)
        czs = torch.where(better, cz, czs)
        rs = torch.where(better, r, rs)
        ms = torch.where(better, mid, ms)
    return t_best, cxs, cys, czs, rs, ms


def _uniform4(params, stream, pixel, samp, dep):
    u = zrng.uniform4(params[P_SEED], pixel, samp, dep, stream)
    return u[..., 0], u[..., 1], u[..., 2], u[..., 3]


def _body_full(c, tables, params, base, mask):
    """The whole segment body (tools/body_probe.py body_full), in its
    operation order; ``mask`` is 0 and keeps the texel index live."""
    ox, oy, oz, dx, dy, dz, tr, tg, tb, ar, ag, ab, dep, samp, slot = c
    sph, mats, cam = tables
    width, height = params[P_WIDTH], params[P_HEIGHT]
    pixel = base + slot * params[P_STRIDE]
    alive = (slot < params[P_NSLOTS]) & (pixel < params[P_NPIX])
    exhausted = alive & (dep >= params[P_MAXDEPTH])
    processing = alive & ~exhausted

    t_best, cxs, cys, czs, rs, ms = _sphere_winner((ox, oy, oz), (dx, dy, dz), sph)
    hit = t_best < BIG
    t_attr = torch.where(hit, t_best, 1.0)
    px_ = ox + t_attr * dx
    py_ = oy + t_attr * dy
    pz_ = oz + t_attr * dz
    safe_r = torch.where(rs.abs() > 1e-8, rs, 1e-8)
    nx = (px_ - cxs) / safe_r
    ny = (py_ - cys) / safe_r
    nz = (pz_ - czs) / safe_r
    front = _dot(dx, dy, dz, nx, ny, nz) <= 0.0
    fsign = torch.where(front, 1.0, -1.0)
    nx, ny, nz = nx * fsign, ny * fsign, nz * fsign
    ony = torch.clamp(ny * fsign, -1.0 + 1e-7, 1.0 - 1e-7)
    theta = _acos(-ony)
    onx = nx * fsign
    onz = nz * fsign
    pole = (onx.abs() + onz.abs()) < 1e-12
    onx = torch.where(pole, 1e-12, onx)
    phi = _atan2(-onz, -onx) + _PI
    uu_ = phi * float(np.float32(1.0 / (2.0 * np.pi)))
    vv_ = theta * float(np.float32(1.0 / np.pi))

    r0_, r1_, r2_, _ = _uniform4(params, zrng.STREAM_SCATTER, pixel, samp, dep)
    row = mats[ms.long()]  # the tool's where-chain over materials, as a lookup
    mtype, ior, textype, col_r, col_g, col_b, tbase, uoff, voff, th, tw = row.unbind(-1)

    def wrap(x):
        x = torch.where(x > 1.0, x - 1.0, x)
        return torch.where(x < 0.0, x + 1.0, x)

    uu = wrap(1.0 - uu_ + uoff)
    vv = wrap(vv_ + voff)
    ix = torch.clamp((uu * tw).to(torch.int32), min=0)
    ix = torch.minimum(ix, tw.to(torch.int32) - 1)
    iy = torch.clamp((vv * th).to(torch.int32), min=0)
    iy = torch.minimum(iy, th.to(torch.int32) - 1)
    texflat = tbase.to(torch.int32) + iy * params[P_ATLASW] + ix

    zr = r0_ * 2.0 - 1.0
    phi_l = float(np.float32(2.0 * np.pi)) * r1_
    rad = vm.sqrt(torch.clamp(1.0 - zr * zr, min=0.0))
    rux = rad * torch.cos(phi_l)
    ruy = rad * torch.sin(phi_l)
    ruz = zr
    lx, ly, lz = nx + rux, ny + ruy, nz + ruz
    degen = (lx * lx + ly * ly + lz * lz) < 1e-12
    lx = torch.where(degen, nx, lx)
    ly = torch.where(degen, ny, ly)
    lz = torch.where(degen, nz, lz)
    ddn = _dot(dx, dy, dz, nx, ny, nz)
    mx = dx - 2.0 * ddn * nx
    my = dy - 2.0 * ddn * ny
    mz = dz - 2.0 * ddn * nz
    met_absorb = _dot(mx, my, mz, nx, ny, nz) <= 0.0
    ratio = torch.where(front, 1.0 / ior, ior)
    cos_t = torch.clamp(-ddn, max=1.0)
    sin_t = vm.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    cannot = ratio * sin_t > 1.0
    r0s = (1.0 - ratio) / (1.0 + ratio)
    x = 1.0 - cos_t
    schl = r0s + (1.0 - r0s) * (x * ((x * x) * (x * x)))  # x ** 5 as XLA's integer_pow
    reflect_now = cannot | (schl > r2_)
    rpx = ratio * (dx + cos_t * nx)
    rpy = ratio * (dy + cos_t * ny)
    rpz = ratio * (dz + cos_t * nz)
    kk = (1.0 - (rpx * rpx + rpy * rpy + rpz * rpz)).abs()
    kpos = kk > 0.0
    kroot = torch.where(kpos, vm.sqrt(torch.where(kpos, kk, 1.0)), 0.0)
    fx = rpx - kroot * nx
    fy = rpy - kroot * ny
    fz = rpz - kroot * nz
    gx = torch.where(reflect_now, mx, fx)
    gy = torch.where(reflect_now, my, fy)
    gz = torch.where(reflect_now, mz, fz)

    is_lam = mtype < 0.5
    is_met = (mtype >= 0.5) & (mtype < 1.5)
    sx = torch.where(is_lam, lx, torch.where(is_met, mx, gx))
    sy = torch.where(is_lam, ly, torch.where(is_met, my, gy))
    sz = torch.where(is_lam, lz, torch.where(is_met, mz, gz))
    sx, sy, sz = _normalize(sx, sy, sz)

    absorbed = is_met & met_absorb
    miss = processing & ~hit
    sc_ = processing & hit & ~absorbed
    path_done = miss | (processing & hit & absorbed) | exhausted

    tsky = 0.5 * (dy + 1.0)
    skyr = (1.0 - tsky) + tsky * 0.5
    skyg = (1.0 - tsky) + tsky * 0.7
    skyb = (1.0 - tsky) + tsky * 1.0
    mf = miss.to(torch.float32)
    ar = ar + mf * tr * skyr
    ag = ag + mf * tg * skyg
    ab = ab + mf * tb * skyb

    use_img = textype > 0.5
    lam_met = is_lam | is_met
    alr = torch.where(lam_met, torch.where(use_img, 1.0, col_r), 1.0)
    alg = torch.where(lam_met, torch.where(use_img, 1.0, col_g), 1.0)
    alb = torch.where(lam_met, torch.where(use_img, 1.0, col_b), 1.0)
    tr = torch.where(sc_, tr * alr, tr)
    tg = torch.where(sc_, tg * alg, tg)
    tb = torch.where(sc_, tb * alb, tb)

    ox = torch.where(sc_, px_, ox)
    oy = torch.where(sc_, py_, oy)
    oz = torch.where(sc_, pz_, oz)
    dx = torch.where(sc_, sx, dx)
    dy = torch.where(sc_, sy, dy)
    dz = torch.where(sc_, sz, dz)
    dep = torch.where(sc_, dep + 1, dep) + (texflat & mask)

    samp2 = samp + path_done.to(torch.int32)
    finished = path_done & (samp2 >= params[P_SEND])
    ar = torch.where(finished, 0.0, ar)
    ag = torch.where(finished, 0.0, ag)
    ab = torch.where(finished, 0.0, ab)
    slot2 = slot + finished.to(torch.int32)
    samp2 = torch.where(finished, params[P_SSTART], samp2)

    pixel2 = base + slot2 * params[P_STRIDE]
    j0, j1, _, _ = _uniform4(params, zrng.STREAM_CAMERA, pixel2, samp2, torch.zeros_like(dep))
    pxf = torch.remainder(pixel2, width).to(torch.float32)
    pyf = _floordiv(pixel2, width).to(torch.float32)
    cu = vm.div(pxf + j0 - 0.5, float(width))
    cv = vm.div(pyf + j1 - 0.5, float(height))
    cox, coy, coz = cam[0], cam[1], cam[2]
    ndx = cam[3] + cu * cam[6] + cv * cam[9] - cox
    ndy = cam[4] + cu * cam[7] + cv * cam[10] - coy
    ndz = cam[5] + cu * cam[8] + cv * cam[11] - coz
    ndx, ndy, ndz = _normalize(ndx, ndy, ndz)

    pd = path_done
    ox = torch.where(pd, cox, ox)
    oy = torch.where(pd, coy, oy)
    oz = torch.where(pd, coz, oz)
    dx = torch.where(pd, ndx, dx)
    dy = torch.where(pd, ndy, dy)
    dz = torch.where(pd, ndz, dz)
    tr = torch.where(pd, 1.0, tr)
    tg = torch.where(pd, 1.0, tg)
    tb = torch.where(pd, 1.0, tb)
    dep2 = torch.where(pd, 0, dep)
    return (ox, oy, oz, dx, dy, dz, tr, tg, tb, ar, ag, ab, dep2, samp2, slot2)


def _body_pass(c, *a):
    return c


def _body_spheres(c, tables, params, base, mask):
    ox, oy, oz, dx, dy, dz, tr, tg, tb, ar, ag, ab, dep, samp, slot = c
    t_best, *_, ms = _sphere_winner((ox, oy, oz), (dx, dy, dz), tables[0])
    return (ox, oy, oz, dx, dy, dz, torch.where(t_best < BIG, tr, t_best), tg,
            tb + ms.to(torch.float32), ar, ag, ab, dep, samp, slot)


def _body_rng(c, tables, params, base, mask):
    ox, oy, oz, dx, dy, dz, tr, tg, tb, ar, ag, ab, dep, samp, slot = c
    pixel = base + slot * params[P_STRIDE]
    r0, r1, r2, _ = _uniform4(params, zrng.STREAM_SCATTER, pixel, samp, dep)
    j0, j1, _, _ = _uniform4(params, zrng.STREAM_CAMERA, pixel, samp, dep)
    return (ox + r0, oy + r1, oz + r2, dx + j0, dy + j1, dz, tr, tg, tb, ar, ag, ab,
            dep, samp, slot)


def _trig(c, acos, atan2):
    ox, oy, oz, dx, dy, dz, tr, tg, tb, ar, ag, ab, dep, samp, slot = c
    ony = torch.clamp(dy, -1.0 + 1e-7, 1.0 - 1e-7)
    theta = acos(-ony)
    phi = atan2(-dz, -dx) + _PI
    s = torch.sin(theta * 2.0)
    co = torch.cos(phi)
    return (ox + s, oy + co, oz + theta, dx, dy, dz, tr, tg, tb, ar, ag, ab, dep, samp, slot)


def _body_trig(c, *a):
    return _trig(c, _acos, _atan2)


def _body_trig_libdevice(c, *a):
    return _trig(c, torch.acos, torch.atan2)


def _body_intdiv(c, tables, params, base, mask):
    ox, oy, oz, dx, dy, dz, tr, tg, tb, ar, ag, ab, dep, samp, slot = c
    pixel = base + slot
    pxf = torch.remainder(pixel, params[P_WIDTH]).to(torch.float32)
    pyf = _floordiv(pixel, params[P_WIDTH]).to(torch.float32)
    return (ox + pxf, oy + pyf, oz, dx, dy, dz, tr, tg, tb, ar, ag, ab, dep, samp, slot)


def _body_mats(c, tables, params, base, mask):
    ox, oy, oz, dx, dy, dz, tr, tg, tb, ar, ag, ab, dep, samp, slot = c
    mats = tables[1]
    ms = torch.remainder(dep, mats.shape[0]).long()
    acc = torch.zeros_like(ox)
    for col in range(11):
        acc = acc + mats[ms, col]
    return (ox + acc, oy, oz, dx, dy, dz, tr, tg, tb, ar, ag, ab, dep, samp, slot)


_PLAIN = dict(pass_=_body_pass, spheres=_body_spheres, rng=_body_rng, trig=_body_trig,
              intdiv=_body_intdiv, mats=_body_mats, full=_body_full,
              trig_libdevice=_body_trig_libdevice)


def body_chain_plain(variant: str, state, base, tables, params, iters: int = B):
    """``iters`` iterations of a body over the lane planes; returns the
    15 planes."""
    body = _PLAIN[variant]
    c = tuple(state)
    for _ in range(iters):
        c = body(c, tables, params, base, 0)
    return c


def body_chain(variant: str, state, base, tables, params, iters: int = B):
    """One launch of the probe kernel on CUDA tensors; the plain version
    on CPU tensors. ``state``: 12 f32
    and 3 int32 planes of one shape; ``base`` int32 of that shape;
    ``tables``: spheres (S, 5), materials (M, 11), camera (12,) f32;
    ``params``: the tool's 10 integers."""
    global LAUNCHES
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}")
    state = tuple(state)
    if (len(state) != N_F32 + N_I32 or len(params) != 10
            or any(t.dtype != torch.float32 for t in state[:N_F32])
            or any(t.dtype != torch.int32 for t in state[N_F32:] + (base,))
            or any(t.shape != base.shape for t in state)):
        raise ValueError("state must be 12 float32 and 3 int32 planes of base's shape, "
                         "params 10 integers")
    if base.device.type == "cpu":
        return body_chain_plain(variant, state, base, tables, params, iters)
    if base.device.type != "cuda":
        raise ValueError(f"body_chain runs on cpu or cuda tensors, not {base.device.type}")
    sph, mats, cam = (t.contiguous() for t in tables)
    if not (1 <= sph.shape[0] <= 32 and 1 <= mats.shape[0] <= 32) or cam.numel() != 12:
        raise ValueError("the kernel takes 1..32 spheres and materials and a 12-float camera")
    if any(t.device != base.device for t in state + (sph, mats, cam)):
        raise ValueError("all tensors must lie on one device")
    ins = torch.stack(state[:N_F32]).contiguous(), torch.stack(state[N_F32:]).contiguous()
    outs = torch.empty_like(ins[0]), torch.empty_like(ins[1])
    prm = (ctypes.c_int * 10)(*(int(p) for p in params))
    _P, _I = ctypes.c_void_p, ctypes.c_int
    fn = common.bind("probe_body", "zr_probe_body_launch",
                     [_I, _P, _I, _P, _I, _P, _P, _P, _P, _P, _P, _I, ctypes.POINTER(ctypes.c_int),
                      _I, _P])
    with torch.cuda.device(base.device):
        common.launch("probe_body", fn, VARIANTS.index(variant), sph.data_ptr(), sph.shape[0],
                      mats.data_ptr(), mats.shape[0], cam.data_ptr(),
                      base.contiguous().data_ptr(), ins[0].data_ptr(), ins[1].data_ptr(),
                      outs[0].data_ptr(), outs[1].data_ptr(), base.numel(), prm, iters)
    LAUNCHES += 1
    return tuple(outs[0].unbind(0)) + tuple(outs[1].unbind(0))


def make_inputs(device, shape=(R_TOT, L), seed: int = 0):
    """(state, base, tables, params) as the tool makes them: random normal
    f32 planes (unnormalized), depth in [0, 5), sample in [0, 10), slot in
    [0, 2), base pixels ``arange % 2^20``, scene 1's tables and the tool's
    parameters (:379-384)."""
    built = three_balls(device)
    tables = scene_tables(built.scene, built.camera)
    n = int(np.prod(shape))
    params = (1000, 1000, 21, 30, 42, 1000000, n, 1, built.scene.atlas.shape[2], 8)
    rng = np.random.default_rng(seed)
    f = lambda: torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(device)
    i = lambda hi: torch.from_numpy(rng.integers(0, hi, shape).astype(np.int32)).to(device)
    state = tuple([f() for _ in range(N_F32)] + [i(5), i(10), i(2)])
    base = (torch.arange(n, dtype=torch.int32, device=device) % (1 << 20)).reshape(shape)
    return state, base, tables, params


# Operations per lane and iteration of ``full``, counted from
# csrc/probe_body.cu (adds, multiplies, divisions, square roots, sin/cos
# and negations as one each; compares and selects not counted; 7 spheres):
# sphere winner 10 + 7 x 21 (each sphere's c.c - r^2 is made once per
# block, bounce_common.cuh sphere_row), hit point, normal and facing 18, the
# polynomial acos/atan2 and uv 32, the material select 0, the texel index
# 6 (as int32 below), Lambertian, mirror and dielectric directions 62,
# normalize 10, sky and radiance 16, throughput 3, the camera ray 27.
FULL_FP32_OPS = 10 + 7 * 21 + 18 + 32 + 62 + 10 + 16 + 3 + 27
# int32 per lane and iteration: pixel and alive 4, two PCG4D draws with
# their seeds 2 x 30, texel index 6, depth, sample and slot updates 6,
# pixel % and // width 4.
FULL_INT_OPS = 4 + 2 * 30 + 6 + 6 + 4


def full_ops(n_lanes: int, iters: int = B) -> tuple[int, int]:
    """(FP32, int32) operations of ``full`` over ``n_lanes`` and ``iters``."""
    return FULL_FP32_OPS * n_lanes * iters, FULL_INT_OPS * n_lanes * iters


# FULL_FP32_OPS's library operations as FP32 instructions of their fast
# paths (each multiply, add or fused multiply-add one instruction, as
# ptxas emits them and csrc/exact_math.cuh writes them out): a division
# (eight) a reciprocal and five fused multiply-adds, a reciprocal (three:
# 1 / |v| twice, 1 / ior) the estimate and two, a square root (thirteen,
# the winner's seven included) the estimate, two multiplies and two, and
# sinf or cosf (two) libdevice's quadrant 2, reduction 3, square 1,
# polynomial 4 and sign 1 (overlap_probe.SIN_INSTRS).
_DIV, _RCP, _SQRT, _TRIG = 8, 3, 13, 2
FULL_FP32_INSTRS = (FULL_FP32_OPS - (_DIV + _RCP + _SQRT + _TRIG)
                    + 6 * _DIV + 3 * _RCP + 5 * _SQRT + 11 * _TRIG)


def full_bytes(n_lanes: int) -> int:
    """Bytes a launch must move: the 15 planes in and out and the base
    plane, once each, and the scene tables."""
    return (16 + 15) * 4 * n_lanes + 4 * (7 * 5 + 5 * 11 + 12)


def full_instructions(n_lanes: int, iters: int = B) -> tuple[int, int]:
    """(FP32 instructions, int32 operations) of ``full``: the work priced at
    one instruction per multiply, add or fused multiply-add."""
    return FULL_FP32_INSTRS * n_lanes * iters, FULL_INT_OPS * n_lanes * iters


# math_check's functions (csrc/probe_body.cu MathFn) -> (launches of
# (first bits or pair index, count)): every float for the one-argument
# functions, 2^32 random pairs, 2^30 near-exact quotients and the 272 x 272
# edge pairs for the division
MATH_CHECKS = {"sin": (0, 1 << 32), "sincos": (0, 1 << 32), "sqrt": (0, 1 << 32),
               "div": (0, 1 << 32), "div_near": (0, 1 << 30), "div_edges": (0, 272 * 272)}


def math_check(device, fn: str) -> tuple[int, int]:
    """(values or pairs on the fast path, of those the ones that differ):
    ``csrc/exact_math.cuh``'s functions against CUDA's on the card, bit for
    bit (``fn``: ``sin`` for sin_fast and cos_fast, ``sincos``, ``sqrt``
    with zeros, ``div``, ``div_near``, ``div_edges``; see
    ``csrc/probe_body.cu`` math_check_kernel)."""
    if torch.device(device).type != "cuda":
        raise ValueError("math_check runs on a CUDA device")
    lo, count = MATH_CHECKS[fn]
    tally = torch.zeros(2, dtype=torch.int64, device=device)
    check = common.bind("probe_body", "zr_probe_math_check",
                        [ctypes.c_int, ctypes.c_uint, ctypes.c_ulonglong, ctypes.c_void_p,
                         ctypes.c_void_p])
    with torch.cuda.device(device):
        common.launch("probe_body", check, list(MATH_CHECKS).index(fn), lo, count,
                      tally.data_ptr())
    return tuple(tally.tolist())


# Tolerance of the float planes, kernel against plain on the card: none.
# Both round every operation separately and call the same correctly
# rounded square root and division; CUDA's sinf/cosf/acosf/atan2f are the
# functions torch's CUDA sin/cos/acos/atan2 call.
def measure(device, variants=VARIANTS) -> list[dict]:
    """One row per variant (see ``probes.common``): on the card the
    kernel equals the plain version on every plane, bit for bit; its time
    is that of K launches in one CUDA graph, as the tool chained K
    launches (so ``pass_`` prices loading and storing the planes)."""
    state, base, tables, params = make_inputs(device)
    n = base.numel()
    rows = []
    for name in variants:
        plain, plain_ms = common.time_ms(
            lambda: body_chain_plain(name, state, base, tables, params), device, repeats=1)
        row = dict(probe="body_probe", variant=name, device=str(device), plain_ms=plain_ms,
                   ms=None, per=None, unit="ns/lane", max_abs_err=None)
        if device.type == "cuda":
            got = body_chain(name, state, base, tables, params)
            row["max_abs_err"] = max(common.compare(f"body_probe {name} plane {k}", g, p)
                                     for k, (g, p) in enumerate(zip(got, plain)))
            row["ms"] = common.time_graph(
                lambda: body_chain(name, state, base, tables, params), device, launches=K)
            row["per"] = row["ms"] / (B * n) * 1e6
        rows.append(row)
    return rows


if __name__ == "__main__":
    sys.exit(common.main_for(measure, VARIANTS, sys.argv[1:]))
