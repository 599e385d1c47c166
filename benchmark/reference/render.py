"""The reference's forward render: every path of chosen pixels, plainly.

One path per (pixel, sample), advanced one segment per step until it
escapes to the sky (its only light), is absorbed, or runs out of depth,
with the Zig tracer's event counts (raytrace.zig:20-34, 60-100): a ray
per segment traced, a reflection per scatter, a background hit per
escape, a recursion-depth hit per path that reaches the depth limit
before tracing, and a sample per path. The random numbers of a segment
are those of (pixel, sample, segment index), so any subset of pixels is
traced exactly as in the whole image. The closest hit takes the spheres
in list order and the triangles by brute force in file order, the
earlier primitive winning exact ties and a sphere beating a triangle at
the same distance.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference import common as cm
from benchmark.reference.scene import DIELECTRIC, LAMBERTIAN, METAL, RefScene

T_MIN = 1e-3
TRI_CHUNK = 512
BATCH = 1 << 16  # paths traced at once


def sphere_winner(scene: RefScene, o, d, t_min=T_MIN):
    """Closest sphere per ray as a running winner in list order (strict
    ``<``: the first sphere keeps ties). Returns ``(t, index)``, t the
    "no hit" distance where none."""
    n = o.shape[0]
    dt = o.dtype
    ox, oy, oz = o[:, 0], o[:, 1], o[:, 2]
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    o_dot_d = cm.dot(o, d)
    o_sq = cm.dot(o, o)
    big = cm.big(dt)
    t_best = torch.full((n,), big, dtype=dt, device=o.device)
    idx = torch.zeros((n,), dtype=torch.int64, device=o.device)
    one = torch.ones((), dtype=dt, device=o.device)
    for s in range(scene.n_spheres):
        cx, cy, cz = scene.sph_center[s, 0], scene.sph_center[s, 1], scene.sph_center[s, 2]
        r = scene.sph_radius[s]
        half_b = o_dot_d - (dx * cx + dy * cy + dz * cz)
        c_sq = cx * cx + cy * cy + cz * cz
        cc = o_sq - 2.0 * (ox * cx + oy * cy + oz * cz) + (c_sq - r * r)
        disc = half_b * half_b - cc
        pos = disc > 0.0
        root = torch.where(pos, cm.sqrt(torch.where(pos, disc, one)), 0.0)
        t1, t2 = -half_b - root, -half_b + root
        ok1 = (t1 > t_min) & (t1 < big)
        ok2 = (t2 > t_min) & (t2 < big)
        t = torch.where(ok1, t1, t2)
        better = (disc >= 0.0) & (ok1 | ok2) & (t < t_best)
        t_best = torch.where(better, t, t_best)
        idx = torch.where(better, s, idx)
    return t_best, idx


def sphere_surface(o, d, t, center, radius):
    """Point, outward normal (over the signed radius) and spherical uv
    (sphere.zig:43-52)."""
    point = o + t[:, None] * d
    tiny = torch.where(radius < 0, -1e-8, 1e-8).to(radius.dtype)
    safe_r = torch.where(torch.abs(radius) > 1e-8, radius, tiny)
    normal = (point - center) / safe_r[:, None]
    ny = torch.clamp(normal[:, 1], -1.0 + 1e-7, 1.0 - 1e-7)
    theta = torch.arccos(-ny)
    nx, nz = normal[:, 0], normal[:, 2]
    nx = torch.where((torch.abs(nx) + torch.abs(nz)) < 1e-12, 1e-12, nx)
    phi = torch.atan2(-nz, -nx) + math.pi
    return point, normal, torch.stack([cm.div(phi, 2.0 * math.pi), cm.div(theta, math.pi)], -1)


class Tris:
    """Per-triangle terms of the determinant form of Moller-Trumbore
    (triangle.zig:32-71), with the unnormalized face normal."""

    def __init__(self, a, b, c):
        self.a, self.b, self.c = a, b, c
        self.e1, self.e2 = b - a, c - a
        self.fn = cm.cross(self.e1, self.e2)
        self.e2xa, self.e1xa = cm.cross(self.e2, a), cm.cross(self.e1, a)
        self.a_dot_fn = cm.dot(a, self.fn)

    def rows(self, sl):
        return (self.fn[sl], self.e1[sl], self.e2[sl], self.e2xa[sl], self.e1xa[sl],
                self.a_dot_fn[sl])


def pair(x, y):
    """``(N, 3)`` by ``(C, 3)`` dot products, ``(N, C)``."""
    return (x[:, None, 0] * y[None, :, 0] + x[:, None, 1] * y[None, :, 1]
            + x[:, None, 2] * y[None, :, 2])


def pair_terms(o, d, oxd, fn, e1, e2, e2xa, e1xa, a_dot_fn):
    """Every (ray, triangle) pair's ``(det, u, v, t)``."""
    det = -pair(d, fn)
    inv_det = 1.0 / torch.where(torch.abs(det) > 1e-12, det, 1.0)
    u = (pair(oxd, e2) - pair(d, e2xa)) * inv_det
    v = -(pair(oxd, e1) - pair(d, e1xa)) * inv_det
    t = (pair(o, fn) - a_dot_fn[None, :]) * inv_det
    return det, u, v, t


def tri_winner(tris: Tris, o, d, t_min=T_MIN):
    """Closest front-facing triangle per ray (``det >= 1e-6``): ``(t,
    index, u, v)``, t the "no hit" distance where none."""
    n, dt = o.shape[0], o.dtype
    big = cm.big(dt)
    oxd = cm.cross(o, d)
    bt = torch.full((n,), big, dtype=dt, device=o.device)
    bi = torch.zeros((n,), dtype=torch.int64, device=o.device)
    bu = torch.zeros((n,), dtype=dt, device=o.device)
    bv = torch.zeros((n,), dtype=dt, device=o.device)
    for start in range(0, tris.a.shape[0], TRI_CHUNK):
        sl = slice(start, start + TRI_CHUNK)
        det, u, v, t = pair_terms(o, d, oxd, *tris.rows(sl))
        ok = (det >= 1e-6) & (t > t_min) & (t < big) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
        t = torch.where(ok, t, big)
        ct, ci = torch.min(t, dim=1)
        better = ct < bt
        bt = torch.where(better, ct, bt)
        bi = torch.where(better, ci + start, bi)
        bu = torch.where(better, torch.gather(u, 1, ci[:, None])[:, 0], bu)
        bv = torch.where(better, torch.gather(v, 1, ci[:, None])[:, 0], bv)
    return bt, bi, bu, bv


def closest_hit(scene: RefScene, tris: Tris | None, o, d):
    """The hit of each ray: ``dict(hit, t, point, normal, front_face, uv,
    mat_id)``, the normal turned against the ray."""
    dt = o.dtype
    big = cm.big(dt)
    ts, si = sphere_winner(scene, o, d)
    t = ts
    use_tri = torch.zeros_like(si, dtype=torch.bool)
    if tris is not None:
        tt, ti, tu, tv = tri_winner(tris, o, d)
        use_tri = tt < ts
        t = torch.where(use_tri, tt, ts)
    hit = t < big
    t_attr = torch.where(hit, t, 1.0)
    point, outward, uv = sphere_surface(o, d, t_attr, scene.sph_center[si], scene.sph_radius[si])
    mat_id = scene.sph_mat[si]
    if tris is not None:
        u3 = use_tri[:, None]
        n_t = cm.normalize_safe(cm.cross(tris.b[ti] - tris.a[ti], tris.c[ti] - tris.a[ti]))
        point = torch.where(u3, o + t_attr[:, None] * d, point)
        outward = torch.where(u3, n_t, outward)
        uv = torch.where(u3, torch.stack([tu, tv], -1), uv)
        mat_id = torch.where(use_tri, scene.tri_mat[ti], mat_id)
    front = cm.dot(d, outward) <= 0.0
    normal = torch.where(front[:, None], outward, -outward)
    return dict(hit=hit, t=t, point=point, normal=normal, front_face=front, uv=uv,
                mat_id=mat_id)


def _wrap(x):
    x = torch.where(x > 1.0, x - 1.0, x)
    return torch.where(x < 0.0, x + 1.0, x)


def albedo(scene: RefScene, tex, uv, bilinear: bool):
    """Texture colour at ``uv`` (texture.zig:31-74: u flipped, offsets
    wrapped once): the nearest texel, truncated and clamped, or the
    bilinear blend of the four around it."""
    const = scene.tex_color[tex]
    img = scene.tex_image[tex]
    is_img = img >= 0
    if not bool(is_img.any()):
        return const
    img = torch.clamp(img, min=0)
    hw = scene.img_hw[img].to(uv.dtype)
    h, w = hw[:, 0], hw[:, 1]
    off = scene.tex_offset[tex]
    uu = _wrap(1.0 - uv[:, 0] + off[:, 0])
    vv = _wrap(uv[:, 1] + off[:, 1])
    base = scene.img_base[img]
    wi = scene.img_hw[img, 1]
    if bilinear:
        fx, fy = uu * w - 0.5, vv * h - 0.5
        x0, y0 = torch.floor(fx), torch.floor(fy)
        tx, ty = (fx - x0)[:, None], (fy - y0)[:, None]
        # a lower precision can leave uv undefined: read texel 0 there
        xs = torch.nan_to_num(torch.stack([x0, x0 + 1.0, x0, x0 + 1.0], 1))
        ys = torch.nan_to_num(torch.stack([y0, y0, y0 + 1.0, y0 + 1.0], 1))
        # clamped as integers: a lower precision may not hold w - 1
        wl, hl = scene.img_hw[img, 1], scene.img_hw[img, 0]
        xi = torch.minimum(torch.clamp(xs, min=0.0).to(torch.int64), (wl - 1)[:, None])
        yi = torch.minimum(torch.clamp(ys, min=0.0).to(torch.int64), (hl - 1)[:, None])
        c = scene.texels[base[:, None] + yi * wi[:, None] + xi]
        color = (c[:, 0] * (1 - tx) * (1 - ty) + c[:, 1] * tx * (1 - ty)
                 + c[:, 2] * (1 - tx) * ty + c[:, 3] * tx * ty)
    else:
        wl, hl = scene.img_hw[img, 1], scene.img_hw[img, 0]
        ix = torch.minimum(torch.clamp((uu * w).to(torch.int32), min=0).long(), wl - 1)
        iy = torch.minimum(torch.clamp((vv * h).to(torch.int32), min=0).long(), hl - 1)
        color = scene.texels[base + iy * wi + ix]
    return torch.where(is_img[:, None], color, const)


def schlick(cosine, ratio):
    """material.zig:125-127, r0 unsquared as the reference has it."""
    r0 = (1.0 - ratio) / (1.0 + ratio)
    x = 1.0 - cosine
    x2 = x * x
    return r0 + (1.0 - r0) * (x * (x2 * x2))


def scatter(scene: RefScene, d, h, rnd, bilinear: bool = False, amp: bool = False):
    """Lambertian, metal and dielectric scatter (material.zig:71-128):
    ``(new_dir, attenuation, absorbed)``, with ``amp`` also the
    refraction's angular magnification for the edge bandwidth (clipped to
    [1, 32] on refractions, 1 on other non-diffuse bounces, 0 on diffuse
    ones)."""
    normal, front, mid = h["normal"], h["front_face"], h["mat_id"]
    mtype = scene.mat_type[mid]
    ior = scene.mat_ior[mid]
    alb = albedo(scene, scene.mat_tex[mid], h["uv"], bilinear)
    lam = normal + cm.random_unit_vector(rnd[:, 0], rnd[:, 1])
    lam = torch.where((cm.dot(lam, lam) < 1e-12)[:, None], normal, lam)
    met = cm.reflect(d, normal)
    met_absorb = cm.dot(met, normal) <= 0.0
    ratio = torch.where(front, 1.0 / ior, ior)
    cos_t = torch.clamp(cm.dot(-d, normal), max=1.0)
    sin_t = cm.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    reflect_now = (ratio * sin_t > 1.0) | (schlick(cos_t, ratio) > rnd[:, 2])
    die = torch.where(reflect_now[:, None], met, cm.refract(d, normal, ratio))
    is_lam, is_met = (mtype == LAMBERTIAN)[:, None], (mtype == METAL)[:, None]
    new_dir = cm.normalize_safe(torch.where(is_lam, lam, torch.where(is_met, met, die)))
    atten = torch.where(is_lam | is_met, alb, torch.ones_like(alb))
    absorbed = (mtype == METAL) & met_absorb
    if not amp:
        return new_dir, atten, absorbed
    is_die = mtype == DIELECTRIC
    cos_out = cm.sqrt(torch.clamp(1.0 - ratio * ratio * (1.0 - cos_t * cos_t), min=1e-6))
    mul = torch.where(is_die & ~reflect_now, torch.clamp(ratio * cos_t / cos_out, 1.0, 32.0), 1.0)
    return new_dir, atten, absorbed, torch.where(is_lam[:, 0], 0.0, mul).detach()


def camera_rays(scene: RefScene, seed, pixel, sample, width: int, height: int, dtype):
    """Jittered primary rays of ``(pixel, sample)`` (raytrace.zig:174-175,
    camera.zig:46-52), row 0 the image's bottom."""
    cam = scene.camera
    j = cm.uniform4(seed, pixel, sample, 0, cm.STREAM_CAMERA, dtype)
    px = (pixel % width).to(dtype)
    py = (pixel // width).to(dtype)
    u = cm.div(px + j[:, 0] - 0.5, float(width))
    v = cm.div(py + j[:, 1] - 0.5, float(height))
    d = cam.lower_left + u[:, None] * cam.horizontal + v[:, None] * cam.vertical - cam.origin
    d = cm.normalize(d)
    return cam.origin.expand(d.shape), d


COUNTERS = ("rays", "reflections", "background_hits", "recursion_depth_hits", "samples")


def trace_paths(scene: RefScene, tris, seed, pixel, sample, width, height, max_depth, dtype):
    """Radiance ``(P, 3)`` of the paths ``(pixel[i], sample[i])`` and
    their event counts (``COUNTERS``)."""
    n, dev = pixel.shape[0], pixel.device
    radiance = torch.zeros((n, 3), dtype=dtype, device=dev)
    counts = dict.fromkeys(COUNTERS, 0)
    counts["samples"] = n
    idx = torch.arange(n, device=dev)
    o, d = camera_rays(scene, seed, pixel, sample, width, height, dtype)
    thr = torch.ones((n, 3), dtype=dtype, device=dev)
    for depth in range(max_depth + 1):
        if idx.numel() == 0:
            break
        if depth == max_depth:  # checked before tracing (raytrace.zig:64-67)
            counts["recursion_depth_hits"] += idx.numel()
            break
        counts["rays"] += idx.numel()
        h = closest_hit(scene, tris, o, d)
        rnd = cm.uniform4(seed, pixel[idx], sample[idx], depth, cm.STREAM_SCATTER, dtype)
        new_dir, atten, absorbed = scatter(scene, d, h, rnd)
        miss = ~h["hit"]
        counts["background_hits"] += int(miss.sum())
        radiance[idx[miss]] = thr[miss] * cm.sky(d[miss])
        go = h["hit"] & ~absorbed
        counts["reflections"] += int(go.sum())
        idx, o, d = idx[go], h["point"][go], new_dir[go]
        thr = thr[go] * atten[go]
    return radiance, counts


def render_pixels(scene: RefScene, seed, pixels, width, height, spp, max_depth,
                  dtype=torch.float32):
    """The image's values at ``pixels`` ``(K,)``, ``(K, 3)``: each the
    sum of its ``spp`` samples in sample order over ``spp``; and the event
    counts of their paths."""
    dev = pixels.device
    k = pixels.shape[0]
    tris = Tris(scene.tri_a, scene.tri_b, scene.tri_c) if scene.n_triangles else None
    per_batch = max(1, BATCH // spp)
    sums = torch.zeros((k, 3), dtype=dtype, device=dev)
    counts = dict.fromkeys(COUNTERS, 0)
    for start in range(0, k, per_batch):
        px = pixels[start:start + per_batch]
        pix = px.repeat_interleave(spp)
        smp = torch.arange(spp, device=dev).repeat(px.shape[0])
        rad, c = trace_paths(scene, tris, seed, pix, smp, width, height, max_depth, dtype)
        rad = rad.reshape(px.shape[0], spp, 3)
        acc = torch.zeros((px.shape[0], 3), dtype=dtype, device=dev)
        for s in range(spp):
            acc = acc + rad[:, s]
        sums[start:start + px.shape[0]] = acc
        for key in COUNTERS:
            counts[key] += c[key]
    return sums / torch.full((), float(spp), dtype=dtype, device=dev), counts


def path_counts(scene: RefScene, seed, pixel, sample, width, height, max_depth,
                dtype=torch.float32) -> dict:
    """The event counts of the paths ``(pixel[i], sample[i])``, traced
    ``BATCH`` at a time."""
    tris = Tris(scene.tri_a, scene.tri_b, scene.tri_c) if scene.n_triangles else None
    counts = dict.fromkeys(COUNTERS, 0)
    for start in range(0, pixel.shape[0], BATCH):
        _, c = trace_paths(scene, tris, seed, pixel[start:start + BATCH],
                           sample[start:start + BATCH], width, height, max_depth, dtype)
        for key in COUNTERS:
            counts[key] += c[key]
    return counts
