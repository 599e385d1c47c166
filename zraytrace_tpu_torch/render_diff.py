"""Differentiable render path.

Counterpart of ``zraytrace_tpu/render_diff.py``. The same light transport
as the wavefront renderer, as a fixed-depth bounce loop that autograd
differentiates, so pixel gradients reach every float leaf of the
``Scene`` (sphere centers and radii, triangle vertices, IORs, texture
colors, atlas texels) and the camera. The RNG is a stateless hash of
(pixel, sample, bounce), so this path draws the wavefront renderer's
sample streams, and both give the same image for the same seed.

Gradient semantics (the JAX module's docstring): discrete choices (which
primitive, reflect or refract, absorb) are piecewise constant; gradients
flow through the continuous quantities at fixed topology, the edge factors
(``edge_eps``, ``edge_grad.py``) add the visibility terms, and the
REINFORCE score (``branch_grad``) the Fresnel branch term. Masked
branches keep the double-where guards: ``torch.where``, like
``jnp.where``, passes NaN back from an unselected branch.

Per bounce, the kernels' outputs — the winner ids of the mesh split and
the three margin-selection ids — are computed first under
``torch.no_grad()``. The differentiable rest of the bounce runs inside
``torch.utils.checkpoint`` (``remat``), which keeps only its inputs and
recomputes it in the backward pass; the ids are inputs, so the backward
pass launches no kernel (the JAX package's ``save_only_these_names(
"edge_sel_idx")``).

``trace_samples`` is the one sample loop of this path: ``render_diff``
and ``inverse.make_sharded_train_step`` trace their samples through it,
as lanes of ``trace_paths`` calls in groups of at most ``MAX_FLAT_LANES``
lanes (``sample_groups``), and it applies each sample's REINFORCE baseline
after the trace.

Spans (``profiling``): ``diff.pack`` (``render_diff``'s own planes),
``diff.sample`` (``trace_paths``), and per bounce ``diff.winner`` and
``diff.margins`` (the no-grad passes) and ``diff.bounce`` (the
checkpointed part, its self time the shading) with ``diff.intersect``
and ``diff.edge`` inside; the last three again, as recompute, in the
backward pass. Counter: ``diff.sample_groups``, the ``trace_paths``
calls of ``trace_samples``.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from zraytrace_tpu_torch import camera as cam
from zraytrace_tpu_torch import materials as mat
from zraytrace_tpu_torch import rng as zrng
from zraytrace_tpu_torch import vecmath as vm
from zraytrace_tpu_torch.diff_trace import (
    pack_for_diff,
    sphere_scan,
    trace_closest_diff,
    tri_winner_ids,
    winner_t,
)
from zraytrace_tpu_torch.edge_grad import edge_factor, select_margin_ids
from zraytrace_tpu_torch.geometry.sphere import BIG
from zraytrace_tpu_torch.profiling import count, span
from zraytrace_tpu_torch.render import background_color, camera_rays, trace_closest
from zraytrace_tpu_torch.scene import Scene

# Meshes of at least this many triangles take the winner-recompute split.
MESH_FAST_MIN_TRIANGLES = 64
# The most lanes of one trace_paths call in trace_samples (pixels x samples):
# it bounds one bounce's recompute memory in the backward pass.
MAX_FLAT_LANES = 1 << 18


def sample_groups(n_pixels: int, spp: int) -> list[int]:
    """The samples of each ``trace_paths`` call ``trace_samples`` makes for
    ``n_pixels`` pixels at ``spp``: consecutive groups of as many samples
    as ``MAX_FLAT_LANES`` lanes hold, one at least."""
    g = max(1, MAX_FLAT_LANES // n_pixels)
    return [min(g, spp - k) for k in range(0, spp, g)]


@span("diff.sample")
def trace_paths(scene: Scene, camera: cam.Camera, pixel_ids, sample_ids, seed, width, height,
                max_depth: int, bilinear_textures: bool = True, remat: bool = True,
                edge_eps=None, edge_occlusion: bool | str = True, mesh_fast: bool | None = None,
                tri_flash=None, branch_grad: bool = False,
                edge_screen: bool = False, edge_kernel: str = "log", return_score: bool = False):
    """Radiance of one path per lane, ``(N, 3)`` (``zraytrace_tpu/
    render_diff.py:39``), for ``(N,)`` pixel and sample ids.

    ``edge_eps``: a bandwidth (or tuple) for the edge factor multiplied
    into the throughput each bounce; ``edge_occlusion``: its t-crossing
    term on every bounce (True), none (False) or camera segments only
    ("camera"). ``mesh_fast``: the winner-recompute split (default: at
    least 64 triangles); ``tri_flash``: original-id planes
    (``diff_trace.pack_for_diff``) for its winner pass and for the margin
    selection. ``branch_grad``: the REINFORCE term of the Fresnel branch,
    ``R d log P``, added forward-zero at each path's termination.
    ``return_score``: return ``(radiance, score)``, ``score`` ``(N,)`` each
    path's ``log P`` at its end (None without ``branch_grad``); a path's
    score stops changing when it ends, so a caller applies a baseline
    ``b`` as ``-b (score - score.detach())`` after the trace
    (``trace_samples`` does). ``edge_screen`` and ``edge_kernel``:
    ``edge_factor``'s ``screen`` and ``kernel``. ``remat``: checkpoint each
    bounce's differentiable part.
    """
    n = pixel_ids.shape[0]
    dev = pixel_ids.device
    f32 = dict(dtype=torch.float32, device=dev)
    o, d = camera_rays(camera, seed, pixel_ids, sample_ids, width, height)
    throughput = torch.ones((n, 3), **f32)
    radiance = torch.zeros((n, 3), **f32)
    alive = torch.ones((n,), dtype=torch.bool, device=dev)
    # the bandwidth amp carry rides with the edge factors, not with
    # branch_grad, so toggling branch_grad leaves other gradients unchanged
    want_amp = edge_eps is not None
    amp = torch.ones((n,), **f32) if (branch_grad or want_amp) else None
    score = torch.zeros((n,), **f32) if branch_grad else None

    fast = (mesh_fast if mesh_fast is not None
            else scene.n_triangles >= MESH_FAST_MIN_TRIANGLES) and scene.n_triangles > 0
    select = edge_eps is not None and scene.n_triangles > 0
    sel_planes = tri_flash if tri_flash is not None and tri_flash.attrs is None else None

    @span("diff.intersect")
    def trace(o, d, winner):
        if fast:
            return trace_closest_diff(scene, o, d, winner=winner)
        return trace_closest(scene, o, d)

    @span("diff.bounce")
    def bounce(depth_idx, winner, sel, o, d, throughput, radiance, alive, amp, score):
        h = trace(o, d, winner)
        if edge_eps is not None:
            occ_w = None
            if edge_occlusion == "camera":
                occ_w = 1.0 if depth_idx == 0 else 0.0
            with span("diff.edge"):
                f = edge_factor(scene, o, d, h, edge_eps, occlusion=bool(edge_occlusion),
                                eps_scale=amp, occ_weight=occ_w, screen=edge_screen,
                                kernel=edge_kernel, sel=sel)
            throughput = throughput * torch.where(alive, f, 1.0)[:, None]
        rnd = zrng.uniform4(seed, pixel_ids, sample_ids, depth_idx, zrng.STREAM_SCATTER)
        out = mat.scatter(scene, d, h["normal"], h["front_face"], h["uv"], h["mat_id"], rnd,
                          bilinear_textures=bilinear_textures,
                          branch_grad=branch_grad or want_amp)
        new_dir, atten, absorbed = out[:3]
        miss = alive & ~h["hit"]
        scattered = alive & h["hit"] & ~absorbed
        contrib = torch.where(miss[:, None], throughput * background_color(d), 0.0)
        radiance = radiance + contrib
        sc3 = scattered[:, None]
        o_next = torch.where(sc3, h["point"], o)
        d_next = torch.where(sc3, new_dir, d)
        throughput = torch.where(sc3, throughput * atten, throughput)
        if branch_grad:
            # a termination and a dielectric scatter exclude each other, so
            # masking by `scattered` makes the order moot
            score = score + torch.where(scattered, out[3], 0.0)
            score0 = (score - score.detach())[:, None]
            radiance = radiance + torch.where(miss[:, None], contrib.detach(), 0.0) * score0
        if amp is not None:
            mul = out[4]  # 0 marks a diffuse bounce: reset
            amp2 = torch.where(mul == 0.0, 1.0, torch.clamp(amp * mul, max=32.0))
            amp = torch.where(scattered, amp2, amp)
        return o_next, d_next, throughput, radiance, scattered, amp, score

    for depth_idx in range(max_depth):
        winner = sel = None
        if fast or select:
            with torch.no_grad():
                with span("diff.winner"):
                    if fast:
                        ts, _ = sphere_scan(scene, o, d)
                        winner = tri_winner_ids(scene, o, d, ts, tri_flash=tri_flash)
                    if select:
                        if fast:  # the hit distance alone: no surface or material work
                            t = winner_t(scene, o, d, ts, winner)
                            h = dict(hit=t < BIG, t=t)
                        else:
                            h = trace_closest(scene, o, d)
                if select:
                    with span("diff.margins"):
                        sel = select_margin_ids(scene, o, d, h, screen=edge_screen,
                                                tri_flash=sel_planes)
        args = (depth_idx, winner, sel, o, d, throughput, radiance, alive, amp, score)
        if remat:
            state = checkpoint(bounce, *args, use_reentrant=False, preserve_rng_state=False)
        else:
            state = bounce(*args)
        o, d, throughput, radiance, alive, amp, score = state
    # paths alive after max_depth bounces contribute black (raytrace.zig:64-67)
    return (radiance, score) if return_score else radiance


def trace_samples(scene: Scene, camera: cam.Camera, pixel_ids, samples: range, seed, width,
                  height, max_depth: int, stop_total, n_before: int, branch_grad: bool = True,
                  **trace_kw):
    """The radiance of ``pixel_ids`` ``(N,)`` summed over the sample ids
    ``samples``, in sample order: ``(total, stop_total)``, both ``(N, 3)``.
    The samples run as lanes of ``trace_paths`` calls (``trace_kw`` its
    arguments), pixel-major within a sample, in consecutive groups of at
    most ``MAX_FLAT_LANES`` lanes (``sample_groups``); each call adds 1 to
    the counter ``diff.sample_groups``. With ``branch_grad``, a sample's
    REINFORCE baseline is the detached mean of the samples before it:
    ``stop_total`` holds the detached sum of the ``n_before`` samples
    before ``samples`` and comes back with these added. Every path ends
    once and its score is fixed from then on, so the baseline's whole
    term is ``-b (score - score.detach())`` of its final score, 0 forward.
    """
    n = pixel_ids.shape[0]
    total = torch.zeros((n, 3), dtype=torch.float32, device=pixel_ids.device)
    k = 0
    for g in sample_groups(n, len(samples)):
        count("diff.sample_groups")
        sample_ids = torch.arange(samples.start + k, samples.start + k + g, dtype=torch.int32,
                                  device=pixel_ids.device).repeat_interleave(n)
        r, score = trace_paths(scene, camera, pixel_ids.repeat(g), sample_ids, seed, width, height,
                               max_depth, branch_grad=branch_grad, return_score=True, **trace_kw)
        r = r.reshape(g, n, 3)
        if branch_grad:
            # sample k's baseline: the mean of the samples before it
            stop = r.detach()
            b = []
            for j in range(g):
                b.append(vm.div(stop_total, max(float(n_before + k + j), 1.0)))
                stop_total = stop_total + stop[j]
            r = r - torch.stack(b) * (score - score.detach()).reshape(g, n, 1)
        for j in range(g):  # in sample order, as one call a sample would add them
            total = total + r[j]
        k += g
    return total, stop_total


def render_diff(scene: Scene, camera: cam.Camera, width: int, height: int, spp: int,
                max_depth: int, seed=42, sample_start=0, bilinear_textures: bool = True,
                edge_eps=None, edge_occlusion: bool | str = True, mesh_fast: bool | None = None,
                tri_flash=None, branch_grad: bool = True, edge_screen: bool = False,
                edge_kernel: str = "log"):
    """Differentiable image ``(H, W, 3)``: the mean over ``spp`` paths per
    pixel (``zraytrace_tpu/render_diff.py:231``), on the scene's device
    (the card, for a scene built with the default device).

    The samples run through one ``trace_samples`` call, which adds them
    in order, so the image does not depend on the grouping. ``branch_grad``
    (default on) adds the REINFORCE term, which changes only the
    ``mat_ior`` gradient. On a CUDA device a scene of at least 64
    triangles whose vertices require no grad packs its own original-id
    planes (``pack_for_diff``) unless ``tri_flash`` is given, so the
    winner pass and the margin selection launch their kernels, once per
    bounce and group; on the CPU nothing is packed unless the caller
    passes planes.
    """
    dev = scene.sph_center.device
    n = width * height
    pixel_ids = torch.arange(n, dtype=torch.int32, device=dev)
    verts_grad = any(x.requires_grad for x in (scene.tri_a, scene.tri_b, scene.tri_c))
    if (tri_flash is None and scene.n_triangles >= MESH_FAST_MIN_TRIANGLES
            and (mesh_fast is None or mesh_fast) and dev.type == "cuda" and not verts_grad):
        with span("diff.pack"):
            tri_flash = pack_for_diff(scene)

    total, _ = trace_samples(scene, camera, pixel_ids, range(sample_start, sample_start + spp),
                             seed, width, height, max_depth,
                             torch.zeros((n, 3), dtype=torch.float32, device=dev), 0, branch_grad,
                             bilinear_textures=bilinear_textures, edge_eps=edge_eps,
                             edge_occlusion=edge_occlusion, mesh_fast=mesh_fast,
                             tri_flash=tri_flash, edge_screen=edge_screen, edge_kernel=edge_kernel)
    return vm.div(total, float(spp)).reshape(height, width, 3)
