"""The reference's differentiable image, losses and Adam steps.

A fixed-depth bounce loop over every pixel, one sample after another,
that autograd differentiates, with the edge factors that give visibility
its gradient (the relaxed-boundary method the traced program documents:
each ray's throughput is multiplied by ``exp(log_w - log_w.detach())``,
1 forward, where ``log_w`` is the mean over bandwidths of log-sigmoids of
the ray's silhouette margin, its near-miss margin and its occlusion
margin). Discrete choices (which primitive, reflect or refract, absorb)
carry no gradient; a ray that refracts widens the bandwidth of the
bounces after it by its angular magnification, and a diffuse bounce
resets it.

The Fresnel branch's score term is left out: it is 0 forward and its
gradient reaches only the materials' indices of refraction, which no
fit here moves. The closest triangle and the triangles whose margins
count are chosen with no gradient by brute force, then their terms are
recomputed differentiably, so gradients reach the vertices through the
chosen triangles alone.
"""

from __future__ import annotations

import torch

from benchmark.reference import common as cm
from benchmark.reference.render import (
    T_MIN,
    TRI_CHUNK,
    Tris,
    camera_rays,
    closest_hit,
    pair_terms,
    scatter,
    sphere_surface,
    sphere_winner,
    tri_winner,
)
from benchmark.reference.scene import RefScene

OCC_EPS_SCALE = 0.125


def _diff_hit(scene: RefScene, o, d):
    """``closest_hit`` with gradients reaching the scene's floats: the
    triangle winner chosen with no gradient, its terms recomputed."""
    if scene.n_triangles == 0:
        return closest_hit(scene, None, o, d)
    big = cm.big(o.dtype)
    ts, si = sphere_winner(scene, o, d)
    with torch.no_grad():
        tris = Tris(scene.tri_a.detach(), scene.tri_b.detach(), scene.tri_c.detach())
        tt, ti, _, _ = tri_winner(tris, o.detach(), d.detach())
        use_tri = tt < ts.detach()
    av, bv, cv = scene.tri_a[ti], scene.tri_b[ti], scene.tri_c[ti]
    e1, e2 = bv - av, cv - av
    fn = cm.cross(e1, e2)
    det = -cm.dot(d, fn)
    inv_det = 1.0 / torch.where(torch.abs(det) > 1e-12, det, 1.0)
    oxd = cm.cross(o, d)
    u = (cm.dot(oxd, e2) - cm.dot(d, cm.cross(e2, av))) * inv_det
    v = -(cm.dot(oxd, e1) - cm.dot(d, cm.cross(e1, av))) * inv_det
    t_rec = (cm.dot(o, fn) - cm.dot(av, fn)) * inv_det
    uv_t = torch.stack([torch.where(use_tri, u, 0.0), torch.where(use_tri, v, 0.0)], -1)
    t = torch.where(use_tri, torch.where(use_tri, t_rec, 1.0), ts)
    hit = t.detach() < big
    t_attr = torch.where(hit, t, 1.0)
    p_s, n_s, uv_s = sphere_surface(o, d, t_attr, scene.sph_center[si], scene.sph_radius[si])
    u3 = use_tri[:, None]
    point = torch.where(u3, o + t_attr[:, None] * d, p_s)
    outward = torch.where(u3, cm.normalize_safe(fn), n_s)
    front = cm.dot(d, outward) <= 0.0
    return dict(hit=hit, t=t, point=point, normal=torch.where(front[:, None], outward, -outward),
                front_face=front, uv=torch.where(u3, uv_t, uv_s),
                mat_id=torch.where(use_tri, scene.tri_mat[ti], scene.sph_mat[si]))


@torch.no_grad()
def _select(scene: RefScene, o, d, t_cap):
    """Per ray, with no gradient: the triangle of the best near miss in
    front of ``t_cap`` (largest negative margin) and the nearest one
    crossed behind it (the occlusion candidate), -1 where none; the
    first of equal candidates wins."""
    n, dt = o.shape[0], o.dtype
    big = cm.big(dt)
    tris = Tris(scene.tri_a.detach(), scene.tri_b.detach(), scene.tri_c.detach())
    oxd = cm.cross(o, d)
    t_excl = t_cap * 1.00001
    runs = [torch.full((n,), -torch.inf, dtype=dt, device=o.device),
            torch.full((n,), big, dtype=dt, device=o.device)]
    ids = [torch.full((n,), -1, dtype=torch.int64, device=o.device) for _ in range(2)]
    for start in range(0, tris.a.shape[0], TRI_CHUNK):
        det, u, v, t = pair_terms(o, d, oxd, *tris.rows(slice(start, start + TRI_CHUNK)))
        m = torch.minimum(torch.minimum(u, v), 1.0 - u - v)
        ok = det >= 1e-6
        near = ok & (t > T_MIN) & (t < t_cap[:, None]) & (m < 0.0)
        occ = ok & (m >= 0.0) & (t > t_excl[:, None])
        for k, vals, largest in ((0, torch.where(near, m, -torch.inf), True),
                                 (1, torch.where(occ, t, big), False)):
            j = torch.argmax(vals, 1) if largest else torch.argmin(vals, 1)
            best = torch.gather(vals, 1, j[:, None])[:, 0]
            better = best > runs[k] if largest else best < runs[k]
            runs[k] = torch.where(better, best, runs[k])
            ids[k] = torch.where(better, j + start, ids[k])
    return ids


def _recompute(scene: RefScene, idx, o, d, oxd):
    """The margin and distance of triangle ``idx`` per ray, differentiable."""
    j = torch.clamp(idx, min=0)
    a, b, c = scene.tri_a[j], scene.tri_b[j], scene.tri_c[j]
    e1, e2 = b - a, c - a
    fn = cm.cross(e1, e2)
    det = -cm.dot(d, fn)
    inv_det = 1.0 / torch.where(torch.abs(det) > 1e-12, det, 1.0)
    u = (cm.dot(oxd, e2) - cm.dot(d, cm.cross(e2, a))) * inv_det
    v = -(cm.dot(oxd, e1) - cm.dot(d, cm.cross(e1, a))) * inv_det
    t = (cm.dot(o, fn) - cm.dot(a, fn)) * inv_det
    return torch.minimum(torch.minimum(u, v), 1.0 - u - v), t


def margins(scene: RefScene, o, d, h):
    """``(margin, occlusion margin, near-miss margin)`` per ray: the
    winner's interior margin on a hit (``disc / 2 r^2`` for a sphere,
    ``min(u, v, 1 - u - v)`` for a triangle) and the best near miss in
    front of the sky on a miss; ``(t2 - t1) / t2`` to the nearest other
    crossing behind the winner (1 where none); the best near miss in
    front of the winner."""
    n, dt, dev = o.shape[0], o.dtype, o.device
    big = cm.big(dt)
    hit = h["hit"]
    t_cap = torch.where(hit, h["t"], big)
    t_excl = t_cap * 1.00001
    t_occ = torch.full((n,), big, dtype=dt, device=dev)
    m_sph = torch.zeros((n,), dtype=dt, device=dev)
    t_best = torch.full((n,), big, dtype=dt, device=dev)
    miss = torch.full((n,), -torch.inf, dtype=dt, device=dev)
    o_dot_d, o_sq = cm.dot(o, d), cm.dot(o, o)
    one = torch.ones((), dtype=dt, device=dev)
    for s in range(scene.n_spheres):
        c, r = scene.sph_center[s], scene.sph_radius[s]
        half_b = o_dot_d - cm.dot(d, c)
        cc = o_sq - 2.0 * cm.dot(o, c) + (cm.dot(c, c) - r * r)
        disc = half_b * half_b - cc
        m = disc / (2.0 * r * r + 1e-12)
        pos = disc > 0.0
        root = torch.where(pos, cm.sqrt(torch.where(pos, disc, one)), 0.0)
        t1, t2 = -half_b - root, -half_b + root
        ok1 = (t1 > T_MIN) & (t1 < big)
        ok2 = (t2 > T_MIN) & (t2 < big)
        t = torch.where(ok1, t1, t2)
        valid = (disc >= 0.0) & (ok1 | ok2)
        better = valid & (t < t_best)
        t_best = torch.where(better, t, t_best)
        m_sph = torch.where(better, m, m_sph)
        near = (disc < 0.0) & (-half_b > T_MIN) & (-half_b < t_cap)
        miss = torch.maximum(miss, torch.where(near, m, -torch.inf))
        t_occ = torch.minimum(t_occ, torch.where(valid & (t > t_excl), t, big))
    m_hit = m_sph
    if scene.n_triangles:
        u, v = h["uv"][:, 0], h["uv"][:, 1]
        m_tri = torch.minimum(torch.minimum(u, v), 1.0 - u - v)
        near_id, occ_id = _select(scene, o.detach(), d.detach(), t_cap.detach())
        oxd = cm.cross(o, d)
        m_near, _ = _recompute(scene, near_id, o, d, oxd)
        miss = torch.maximum(miss, torch.where(near_id >= 0, m_near, -torch.inf))
        _, t_o = _recompute(scene, occ_id, o, d, oxd)
        t_occ = torch.minimum(t_occ, torch.where(occ_id >= 0, t_o, big))
        m_hit = torch.where(hit & (h["t"] < t_best), m_tri, m_sph)
    miss = torch.clamp(miss, min=-1e3)
    has_occ = hit & (t_occ < big)
    occ = torch.where(has_occ, (t_occ - t_cap) / torch.where(has_occ, t_occ, 1.0), 1.0)
    return torch.where(hit, m_hit, miss), occ, miss


def edge_factor(scene: RefScene, o, d, h, eps, occlusion: bool, amp):
    """The throughput factor: exactly 1 forward, the boundary terms
    backward."""
    m, m_occ, m_near = margins(scene, o, d, h)
    hit = h["hit"]
    log_w = torch.zeros_like(m)
    for e0 in eps:
        e = e0 * amp.detach()
        w = torch.sigmoid(m / e)
        near_c = torch.clamp(1.0 - torch.sigmoid(m_near / e), min=1e-6)
        lg = torch.log(torch.where(hit, torch.clamp(w, min=1e-6) * near_c, near_c))
        if occlusion:
            wo = torch.clamp(torch.sigmoid(m_occ / (e * OCC_EPS_SCALE)), min=1e-6)
            lg = lg + torch.where(hit, torch.log(wo), 0.0)
        log_w = log_w + lg
    log_w = log_w / len(eps)
    return torch.exp(log_w - log_w.detach())


def radiance(scene: RefScene, seed, pixel, sample, width, height, max_depth, eps, occlusion):
    """One path's radiance per lane ``(N, 3)``, differentiable."""
    n, dt, dev = pixel.shape[0], scene.sph_center.dtype, pixel.device
    o, d = camera_rays(scene, seed, pixel, sample, width, height, dt)
    thr = torch.ones((n, 3), dtype=dt, device=dev)
    rad = torch.zeros((n, 3), dtype=dt, device=dev)
    alive = torch.ones((n,), dtype=torch.bool, device=dev)
    amp = torch.ones((n,), dtype=dt, device=dev)
    for depth in range(max_depth):
        h = _diff_hit(scene, o, d)
        f = edge_factor(scene, o, d, h, eps, occlusion, amp)
        thr = thr * torch.where(alive, f, 1.0)[:, None]
        rnd = cm.uniform4(seed, pixel, sample, depth, cm.STREAM_SCATTER, dt)
        new_dir, atten, absorbed, mul = scatter(scene, d, h, rnd, bilinear=True, amp=True)
        miss = alive & ~h["hit"]
        go = alive & h["hit"] & ~absorbed
        rad = rad + torch.where(miss[:, None], thr * cm.sky(d), 0.0)
        g3 = go[:, None]
        o = torch.where(g3, h["point"], o)
        d = torch.where(g3, new_dir, d)
        thr = torch.where(g3, thr * atten, thr)
        amp2 = torch.where(mul == 0.0, 1.0, torch.clamp(amp * mul, max=32.0))
        amp = torch.where(go, amp2, amp)
        alive = go
    return rad


def image(scene: RefScene, seed, width, height, spp, max_depth, eps, occlusion):
    """The differentiable image ``(H, W, 3)``: the mean of ``spp`` paths
    per pixel, summed in sample order; row 0 the bottom."""
    dev = scene.sph_center.device
    n = width * height
    pixel = torch.arange(n, device=dev)
    total = torch.zeros((n, 3), dtype=scene.sph_center.dtype, device=dev)
    for k in range(spp):
        sample = torch.full((n,), k, dtype=torch.int64, device=dev)
        total = total + radiance(scene, seed, pixel, sample, width, height, max_depth, eps,
                                 occlusion)
    return cm.div(total, float(spp)).reshape(height, width, 3)


def adam_steps(loss_fn, leaves: dict, lr: float, steps: int, betas=(0.9, 0.999), eps=1e-8,
               points: list | None = None, state: dict | None = None):
    """``steps`` steps of PyTorch's Adam (the optimizer the benchmark gives
    the program, so both sides round its update alike) on ``leaves``
    (name to tensor). Returns the losses, the first step's gradients and
    the parameters before each step and after the last.

    With ``points`` (another side's parameters before each step), each
    loss and gradient is taken at that side's point, and this side's
    Adam moves from the first point with those gradients: the reference
    follows the other side step by step. The fits' gradients are
    discontinuous at the scale of a unit in the last place (which
    triangle's edge term a ray takes flips), so two sides whose updates
    round apart take different gradients from the second step on.
    ``state`` (name to Adam's per-leaf state: ``step``, ``exp_avg``,
    ``exp_avg_sq``) is the optimizer's state to start from; without it
    Adam starts fresh."""
    start = leaves if points is None else points[0]
    p = {k: v.detach().clone().requires_grad_(True) for k, v in start.items()}
    opt = torch.optim.Adam(list(p.values()), lr=lr, betas=betas, eps=eps)
    for k, st in (state or {}).items():
        opt.state[p[k]] = {s: t.clone() if s == "step" else t.to(p[k]).clone()
                           for s, t in st.items()}
    losses, first, seen = [], None, []
    for i in range(steps):
        at = p if points is None else {k: v.detach().clone().requires_grad_(True)
                                       for k, v in points[i].items()}
        seen.append({k: v.detach().clone() for k, v in at.items()})
        loss = loss_fn(at)
        grads = torch.autograd.grad(loss, list(at.values()), allow_unused=True)
        for (k, v), g in zip(p.items(), grads):
            v.grad = torch.zeros_like(v) if g is None else g.detach()
        losses.append(float(loss.detach()))
        if first is None:
            first = {k: v.grad.clone() for k, v in p.items()}
        opt.step()
    seen.append({k: v.detach().clone() for k, v in p.items()})
    return losses, first, seen
