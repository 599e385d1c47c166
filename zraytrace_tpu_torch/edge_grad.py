"""Edge-aware (silhouette and occlusion) gradients for inverse rendering.

Counterpart of ``zraytrace_tpu/edge_grad.py``; the derivation is there.
Per bounce, each ray gets the signed margin of its decisive boundary —
positive for hit rays (the winner's interior margin: ``disc / (2 r^2)``
for a sphere, ``min(u, v, 1-u-v)`` for a triangle), negative for the best
near miss in front of what the ray hit — and an occlusion margin
``(t2 - t1) / t2`` to the nearest other crossing behind the winner. The
path throughput is multiplied by ``exp(log_w - log_w.detach())`` with
``log_w`` a sum of log-sigmoids of the margins over the bandwidth: exactly
1.0 forward, the relaxed boundary terms backward.

Triangles use select-recompute for every mesh size: a scan with no
gradient picks, per ray, the near-miss argmax, the occlusion argmin and
(screen mode) the winner, and the margins are recomputed differentiably
on those triangles alone. A max or min passes its gradient through the
selected element, so values and gradients equal the dense form the JAX
package keeps below 64 triangles. With original-id flash planes
(``diff_trace.pack_for_diff``) the selection is ``flash_margin_select``
(the CUDA kernel on the card); without, a brute chunked scan.

The JAX package's environment switches are arguments here:
``ZRAYTRACE_EDGE_SCREEN`` is ``screen``, ``ZRAYTRACE_EDGE_KERNEL`` is
``kernel`` ("log" or "exact"), and ``ZRAYTRACE_EDGE_SELECT`` /
``ZRAYTRACE_EDGE_FLASH`` are the rule above.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from zraytrace_tpu_torch import vecmath as vm
from zraytrace_tpu_torch.geometry.sphere import BIG
from zraytrace_tpu_torch.geometry.triangle import DET_EPS, TrianglePack, pack_triangles
from zraytrace_tpu_torch.ops import flash_intersect as fi
from zraytrace_tpu_torch.scene import Scene

# Margins are relative (sphere: fraction of radius; triangle: barycentric),
# so one bandwidth serves both primitive types.
DEFAULT_EDGE_EPS = 0.01

# The occlusion sigmoid's bandwidth is eps * OCC_EPS_SCALE: a relative-t
# gap maps a screen-space band to a much narrower t band than a
# silhouette's (measured in the JAX package, round 3).
OCC_EPS_SCALE = 0.125

# Triangles per chunk of the brute selection scan.
TRI_CHUNK = 512


class MarginIds(NamedTuple):
    """Selected triangles per ray (original ids, -1 where none): the
    near-miss argmax, the occlusion argmin and, in screen mode, the winner
    whose angular margin the hit ray takes."""

    near: torch.Tensor  # (N,) int32
    occ: torch.Tensor
    win: torch.Tensor


def _pair(x, y):
    """``(N, 3)`` x ``(C, 3)`` -> ``(N, C)`` dot products."""
    return (x[:, None, 0] * y[None, :, 0] + x[:, None, 1] * y[None, :, 1]
            + x[:, None, 2] * y[None, :, 2])


def _screen_scale(fn, e1, e2):
    """Edge heights ``|fn| / |e|`` over the three edges (|fn| = 2 Area):
    barycentric margin times height is a geometric distance."""
    fl = vm.sqrt(vm.dot(fn, fn))
    hu = fl / torch.clamp(vm.sqrt(vm.dot(e2, e2)), min=1e-12)
    hv = fl / torch.clamp(vm.sqrt(vm.dot(e1, e1)), min=1e-12)
    ew = e2 - e1
    hw = fl / torch.clamp(vm.sqrt(vm.dot(ew, ew)), min=1e-12)
    return hu, hv, hw


def _screen_margin(uu, vv, tt, hu, hv, hw, t_min):
    """Angular margin: the distance to the nearest edge over the
    candidate's own distance."""
    return (torch.minimum(torch.minimum(uu * hu, vv * hv), (1.0 - uu - vv) * hw)
            / torch.clamp(torch.abs(tt), min=t_min))


@torch.no_grad()
def _brute_select(scene: Scene, o, d, t_cap, t_min, screen) -> MarginIds:
    """The selection scan without planes (``edge_grad.py:297-350``): all
    triangles in chunks of ``TRI_CHUNK``, the first of equal candidates
    winning within a chunk and strict comparisons across chunks."""
    n, dev = o.shape[0], o.device
    T = scene.n_triangles
    chunk = TRI_CHUNK
    n_chunks = -(-T // chunk)
    pad = n_chunks * chunk - T
    p3 = lambda x: torch.cat([x.detach(), x.new_zeros((pad, 3))])
    pack = pack_triangles(p3(scene.tri_a), p3(scene.tri_b), p3(scene.tri_c))
    oxd = vm.cross(o, d)
    t_excl = t_cap * 1.00001
    t_low = t_cap * 0.99999
    f32 = dict(dtype=torch.float32, device=dev)
    mm = torch.full((n,), -torch.inf, **f32)
    tocc = torch.full((n,), BIG, **f32)
    mw = torch.full((n,), -torch.inf, **f32)
    ids = torch.full((3, n), -1, dtype=torch.int64, device=dev)
    for i in range(n_chunks):
        p = TrianglePack(*(x[i * chunk:(i + 1) * chunk] for x in pack))
        det = -_pair(d, p.fn)
        inv_det = 1.0 / torch.where(torch.abs(det) > 1e-12, det, 1.0)
        uu = (_pair(oxd, p.e2) - _pair(d, p.e2xa)) * inv_det
        vv = -(_pair(oxd, p.e1) - _pair(d, p.e1xa)) * inv_det
        tt = (_pair(o, p.fn) - p.a_dot_fn[None, :]) * inv_det
        m = torch.minimum(torch.minimum(uu, vv), 1.0 - uu - vv)
        if screen:
            hu, hv, hw = _screen_scale(p.fn, p.e1, p.e2)
            m_s = _screen_margin(uu, vv, tt, hu[None], hv[None], hw[None], t_min)
        else:
            m_s = m
        ok = det >= DET_EPS
        near = ok & (tt > t_min) & (tt < t_cap[:, None]) & (m < 0.0)
        occ = ok & (m >= 0.0) & (tt > t_excl[:, None])
        cands = [(mm, torch.where(near, m_s, -torch.inf), True),
                 (tocc, torch.where(occ, tt, BIG), False)]
        if screen:
            win = (ok & (m >= 0.0) & (tt > t_min) & (tt <= t_excl[:, None])
                   & (tt >= t_low[:, None]))
            cands.append((mw, torch.where(win, m_s, -torch.inf), True))
        for k, (run, vals, largest) in enumerate(cands):
            j = torch.argmax(vals, 1) if largest else torch.argmin(vals, 1)  # first extreme
            best = torch.gather(vals, 1, j[:, None])[:, 0]
            better = (best > run) if largest else (best < run)
            run.copy_(torch.where(better, best, run))
            ids[k] = torch.where(better, j + i * chunk, ids[k])
    return MarginIds(*(x.to(torch.int32) for x in ids))


@torch.no_grad()
def select_margin_ids(scene: Scene, o, d, h, t_min=1e-3, screen: bool = False,
                      tri_flash=None) -> MarginIds:
    """The triangles whose margins ``silhouette_margin`` recomputes, with no
    gradient (the JAX package's ``edge_sel_idx``). ``tri_flash``:
    original-id planes route it through ``flash_margin_select``; else the
    brute scan. Outside screen mode the winner id is -1 (the hit ray's
    margin is its uv margin)."""
    t_cap = torch.where(h["hit"], h["t"].detach(), BIG)
    o, d = o.detach(), d.detach()
    if tri_flash is not None:
        near, occ, win = fi.flash_margin_select(tri_flash, o, d, t_cap, t_min)
        if not screen:
            win = torch.full_like(win, -1)
        return MarginIds(near, occ, win)
    return _brute_select(scene, o, d, t_cap, t_min, screen)


def _recompute(pack: TrianglePack, idx, o, d, oxd, t_min, screen):
    """Differentiable margin and t of ONE selected triangle per ray, the
    formulas of the scan, row-wise. Returns ``(m_s, t)``."""
    j = torch.clamp(idx, min=0).long()
    fn, e1, e2 = pack.fn[j], pack.e1[j], pack.e2[j]
    det = -vm.dot(d, fn)
    inv_det = 1.0 / torch.where(torch.abs(det) > 1e-12, det, 1.0)
    uu = (vm.dot(oxd, e2) - vm.dot(d, pack.e2xa[j])) * inv_det
    vv = -(vm.dot(oxd, e1) - vm.dot(d, pack.e1xa[j])) * inv_det
    tt = (vm.dot(o, fn) - pack.a_dot_fn[j]) * inv_det
    if screen:
        return _screen_margin(uu, vv, tt, *_screen_scale(fn, e1, e2), t_min), tt
    return torch.minimum(torch.minimum(uu, vv), 1.0 - uu - vv), tt


def silhouette_margin(scene: Scene, o, d, h, t_min=1e-3, screen: bool = False, tri_flash=None,
                      sel: MarginIds | None = None):
    """Signed silhouette margin per ray, the occlusion margin and the
    near-miss margin: ``(margin (N,), occ_margin (N,), near_margin (N,))``
    (``zraytrace_tpu/edge_grad.py:93``). ``h`` is the hit dict of
    ``trace_closest`` / ``trace_closest_diff``.

    ``margin`` is the winner's interior margin on hit rays and the best
    near-miss margin in front of the sky on miss rays; ``near_margin`` is
    the best near-miss margin in front of the winner for every ray;
    ``occ_margin = (t2 - t1) / t2`` to the nearest other crossing behind the
    winner (1.0 where none). ``screen``: angular margins (geometric
    distance over the candidate's own distance) in place of relative ones.
    ``sel``: the triangle selection when the caller ran it already; else
    ``select_margin_ids`` runs here (through ``tri_flash`` when given).
    """
    n = o.shape[0]
    f32 = dict(dtype=torch.float32, device=o.device)
    hit = h["hit"]
    t_cap = torch.where(hit, h["t"], BIG)
    t_first = t_cap
    t_excl = t_first * 1.00001
    t_occ = torch.full((n,), BIG, **f32)
    margin_hit_sph = torch.zeros((n,), **f32)
    t_best = torch.full((n,), BIG, **f32)
    miss_margin = torch.full((n,), -torch.inf, **f32)

    if scene.n_spheres > 0:
        o_dot_d = vm.dot(o, d)
        o_sq = vm.length_squared(o)
        one = torch.ones((), **f32)
        for s in range(scene.n_spheres):
            c = scene.sph_center[s]
            r = scene.sph_radius[s]
            half_b = o_dot_d - vm.dot(d, c)
            cc = o_sq - 2.0 * vm.dot(o, c) + (vm.dot(c, c) - r * r)
            disc = half_b * half_b - cc
            m = disc / (2.0 * r * r + 1e-12)
            pos = disc > 0.0
            root = torch.where(pos, vm.sqrt(torch.where(pos, disc, one)), 0.0)
            t1 = -half_b - root
            t2 = -half_b + root
            ok1 = (t1 > t_min) & (t1 < BIG)
            ok2 = (t2 > t_min) & (t2 < BIG)
            t = torch.where(ok1, t1, t2)
            valid = (disc >= 0.0) & (ok1 | ok2)
            better = valid & (t < t_best)
            if screen:
                m_hit_s = m * r / torch.clamp(torch.where(valid, t, 1.0), min=t_min)
                m_near_s = m * r / torch.clamp(-half_b, min=t_min)
            else:
                m_hit_s = m_near_s = m
            t_best = torch.where(better, t, t_best)
            margin_hit_sph = torch.where(better, m_hit_s, margin_hit_sph)
            # near miss: the tangency point (-half_b) in front, before t_cap
            near = (disc < 0.0) & (-half_b > t_min) & (-half_b < t_cap)
            miss_margin = torch.maximum(miss_margin, torch.where(near, m_near_s, -torch.inf))
            # occlusion: this sphere's root behind the ray's winner
            occ = valid & (t > t_excl)
            t_occ = torch.minimum(t_occ, torch.where(occ, t, BIG))

    hit_is_tri = hit & (h["t"] < t_best) & (scene.n_triangles > 0)
    if scene.n_triangles > 0:
        u, v = h["uv"][:, 0], h["uv"][:, 1]
        margin_hit_tri = torch.minimum(torch.minimum(u, v), 1.0 - u - v)
        if sel is None:
            sel = select_margin_ids(scene, o, d, h, t_min, screen, tri_flash)
        pack = pack_triangles(scene.tri_a, scene.tri_b, scene.tri_c)
        oxd = vm.cross(o, d)
        m_near_t, _ = _recompute(pack, sel.near, o, d, oxd, t_min, screen)
        miss_margin = torch.maximum(miss_margin, torch.where(sel.near >= 0, m_near_t, -torch.inf))
        _, t_occ_t = _recompute(pack, sel.occ, o, d, oxd, t_min, screen)
        t_occ = torch.minimum(t_occ, torch.where(sel.occ >= 0, t_occ_t, BIG))
        if screen:
            m_win_t, _ = _recompute(pack, sel.win, o, d, oxd, t_min, screen)
            margin_hit_tri = torch.where(sel.win >= 0, m_win_t, margin_hit_tri)
    else:
        margin_hit_tri = torch.zeros((n,), **f32)

    margin_hit = torch.where(hit_is_tri, margin_hit_tri, margin_hit_sph)
    # near-missed nothing: -inf -> a large negative, so backward stays finite
    miss_margin = torch.clamp(miss_margin, min=-1e3)
    has_occ = hit & (t_occ < BIG)
    occ_margin = torch.where(has_occ, (t_occ - t_first) / torch.where(has_occ, t_occ, 1.0), 1.0)
    return torch.where(hit, margin_hit, miss_margin), occ_margin, miss_margin


def edge_factor(scene: Scene, o, d, h, eps=DEFAULT_EDGE_EPS, t_min=1e-3, occlusion: bool = True,
                eps_scale=None, occ_weight=None, screen: bool = False, kernel: str = "log",
                tri_flash=None, sel: MarginIds | None = None):
    """Per-ray throughput factor ``(N,)``: exactly 1.0 forward, silhouette
    and occlusion gradients backward (``zraytrace_tpu/edge_grad.py:464``).

    ``eps``: a bandwidth or a tuple of them; the factor is the geometric
    mean over bandwidths, so the gradient is the mean (bias cancellation).
    The occlusion term runs at ``eps * OCC_EPS_SCALE``. Hit rays carry the
    winner's interior term and the complement of their near-miss term;
    miss rays the complement of their near-miss term. ``eps_scale``: a
    per-ray bandwidth multiplier (detached; ``render_diff``'s refraction
    amplification). ``occ_weight``: a factor on the occlusion term's
    gradient (``render_diff`` passes 0 past the camera segment for
    ``edge_occlusion="camera"``). ``kernel``: "log" (log-sigmoid, the
    default the shipped fits are calibrated on) or "exact" (per-side
    ``2 * sigmoid`` kernels whose backward integrates to 1 per side).
    """
    if kernel not in ("log", "exact"):
        raise ValueError(f"kernel must be 'log' or 'exact', not {kernel!r}")
    m, m_occ, m_near = silhouette_margin(scene, o, d, h, t_min=t_min, screen=screen,
                                         tri_flash=tri_flash, sel=sel)
    eps_list = tuple(eps) if isinstance(eps, (tuple, list)) else (eps,)
    scale = 1.0 if eps_scale is None else eps_scale.detach()
    hit = h["hit"]
    log_w = torch.zeros_like(m)
    for e0 in eps_list:
        e = e0 * scale
        if kernel == "exact":
            lg = torch.where(hit, 2.0 * torch.sigmoid(m / e), 0.0) - 2.0 * torch.sigmoid(m_near / e)
            occ_lg = torch.where(hit, 2.0 * torch.sigmoid(m_occ / (e * OCC_EPS_SCALE)), 0.0)
        else:
            w = torch.sigmoid(m / e)
            near_c = torch.clamp(1.0 - torch.sigmoid(m_near / e), min=1e-6)
            lg = torch.log(torch.where(hit, torch.clamp(w, min=1e-6) * near_c, near_c))
            wo = torch.clamp(torch.sigmoid(m_occ / (e * OCC_EPS_SCALE)), min=1e-6)
            occ_lg = torch.where(hit, torch.log(wo), 0.0)
        if occlusion:
            if occ_weight is not None:
                occ_lg = occ_lg * occ_weight
            lg = lg + occ_lg
        log_w = log_w + lg
    log_w = log_w / len(eps_list)
    # exactly 0.0 forward (x - x), so exp gives 1.0 bit for bit
    return torch.exp(log_w - log_w.detach())
