"""Mesh-scale inverse rendering: recover a teapot's pose (a translation)
from a target image by gradient descent through the renderer.

Counterpart of ``examples/mesh_fit.py``. Each step moves the teapot by
the current offset, repacks its flash planes in the BVH order of the
initial vertices (a translation keeps the order valid) and renders with
``render_diff``'s winner-recompute split: on the card every bounce's
winner pass launches the flash kernel, and the silhouette-margin
selection of the edge factors (at ``(eps, 2 eps)``) the margin kernel.
The image is ``kernel_inputs.pose_image``. Adam (optax's constants) from
``init * (0.5, -0.35, 0.45)``; the fit converged when the pose error is
below 0.08.

``--goat`` fits the goat-class stand-in instead: ``scenes.goat_class``'s
5x5 grid of teapots (158,000 triangles) and camera, in the example's red
Lambertian material on the green ground. ``--screen`` ranks silhouette
margins in screen space (use with ``--eps 5e-4``); ``--occlusion`` puts
the t-crossing term on no segment, camera segments (the default) or
every bounce; ``--coarse`` starts the bandwidth at ``coarse * eps`` and
decays it geometrically to ``eps`` over the first 60% of the steps.

    python -m zraytrace_tpu_torch.examples.mesh_fit [--steps 120] [--screen]
        [--eps 0.015] [--goat] [--init 0.5] [--lr 2e-2] [--tris N] [--cpu]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from zraytrace_tpu_torch.tools.common import card_info, pick_device, sync

__all__ = ["INIT", "BAR", "OCCLUSION", "pose_scene", "fit_pose", "run", "main"]

INIT = (0.5, -0.35, 0.45)
BAR = 0.08
OCCLUSION = {"off": False, "camera": "camera", "all": True}


def pose_scene(goat: bool = False, tris: int = 0, device="cuda"):
    """``(base scene, camera)``: the teapot on the ground (its first
    ``tris`` triangles when ``tris`` > 0), or the goat-class grid in the
    same red material with ``goat_class``'s camera."""
    from zraytrace_tpu_torch import scene as sc
    from zraytrace_tpu_torch.scenes import goat_class, teapot_on_ground

    if not goat:
        b = teapot_on_ground(device)
        base = b.scene
        if tris:
            base = base._replace(**{k: getattr(base, k)[:tris]
                                    for k in ("tri_a", "tri_b", "tri_c", "tri_mat")})
        return base, b.camera
    g = goat_class("cpu")
    b = sc.SceneBuilder()
    b.add_sphere((0.0, -102.33, 7.0), 100.0, b.add_lambertian_color(sc.COLOR_GREEN))
    verts = [getattr(g.scene, k).numpy() for k in ("tri_a", "tri_b", "tri_c")]
    if tris:
        verts = [v[:tris] for v in verts]
    b.add_triangles(*verts, b.add_lambertian_color((0.7, 0.15, 0.1)))
    return b.build(device), g.camera.to(device)


def fit_pose(base, camera, steps: int = 120, size: int = 64, spp: int = 8, depth: int = 4,
             lr: float = 2e-2, eps: float = 0.015, screen: bool = False,
             occlusion: str = "camera", coarse: float = 1.0, init: float = 0.5,
             device="cuda", verbose: bool = True) -> dict:
    """Fit the offset of ``base``'s triangles toward the image at offset
    0. Returns ``error_start``, ``error_end``, per step ``losses`` and
    ``errors`` (after the step), ``step0_seconds`` and ``seconds`` (the
    other steps, the card synchronised) and the ``target`` image."""
    from zraytrace_tpu_torch.geometry.bvh import build_tri_bvh
    from zraytrace_tpu_torch.kernel_inputs import pose_image

    device = torch.device(device)
    order = build_tri_bvh(base.tri_a, base.tri_b, base.tri_c).prim_order.to(device)
    dims = dict(width=size, height=size, spp=spp, depth=depth)
    occ = OCCLUSION[occlusion]

    def image(off, e):
        return pose_image(base, camera, order, off, e, screen, occ, **dims)

    true_off = torch.zeros(3, dtype=torch.float32, device=device)
    with torch.no_grad():
        target = image(true_off, eps)

    def eps_at(i):
        frac = min(1.0, i / max(1, int(0.6 * steps)))
        return float(np.float32(eps * coarse ** (1.0 - frac)))

    init_off = torch.tensor(INIT, dtype=torch.float32, device=device) * init
    off = init_off.clone().requires_grad_(True)
    opt = torch.optim.Adam([off], lr=lr, betas=(0.9, 0.999), eps=1e-8)
    losses, errors = [], []

    def step(i):
        opt.zero_grad(set_to_none=True)
        loss = ((image(off, eps_at(i)) - target) ** 2).mean()
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
        errors.append(float((off.detach() - true_off).norm()))

    sync(device)
    t0 = time.perf_counter()
    step(0)
    sync(device)
    step0 = time.perf_counter() - t0
    if verbose:
        print(f"step0: {step0:.1f}s (tris={base.n_triangles})", flush=True)
    t0 = time.perf_counter()
    for i in range(1, steps):
        step(i)
        if verbose and (i % 10 == 0 or i == steps - 1):
            print(f"step {i:3d} loss {losses[-1]:.3e} |pose error| {errors[-1]:.4f}",
                  flush=True)
    sync(device)
    seconds = time.perf_counter() - t0
    err0 = float(init_off.norm())
    if verbose:
        print(f"{steps - 1} steps in {seconds:.1f}s ({seconds / max(steps - 1, 1):.2f}s/step); "
              f"pose error {err0:.3f} -> {errors[-1]:.4f}", flush=True)
    return dict(error_start=err0, error_end=errors[-1], losses=losses, errors=errors,
                step0_seconds=step0, seconds=seconds, steps=steps,
                n_triangles=base.n_triangles, target=target.cpu())


def run(argv=None) -> dict:
    """Parse ``argv`` and fit: ``fit_pose``'s result with ``ok`` and the
    device."""
    ap = argparse.ArgumentParser(prog="python -m zraytrace_tpu_torch.examples.mesh_fit")
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--spp", type=int, default=8)
    ap.add_argument("--depth", type=int, default=4)
    ap.add_argument("--cpu", action="store_true", help="run on the host, not the card")
    ap.add_argument("--tris", type=int, default=0,
                    help="optional triangle-count cap (0 = the whole mesh)")
    ap.add_argument("--goat", action="store_true",
                    help="the goat-class scene: a 5x5 teapot grid, 158,000 triangles")
    ap.add_argument("--init", type=float, default=0.5,
                    help="scale of the initial pose offset; far inits (>~1) want --coarse "
                         "or --screen")
    ap.add_argument("--lr", type=float, default=2e-2)
    ap.add_argument("--screen", action="store_true",
                    help="screen-space silhouette margins (use with --eps ~5e-4)")
    ap.add_argument("--eps", type=float, default=0.015,
                    help="edge bandwidth (the pair (eps, 2*eps) is used)")
    ap.add_argument("--occlusion", choices=tuple(OCCLUSION), default="camera",
                    help="t-crossing occlusion term: off, camera segments only, or every "
                         "bounce")
    ap.add_argument("--coarse", type=float, default=1.0,
                    help="start the bandwidth at coarse*eps and decay it geometrically to "
                         "eps over the first 60%% of steps (1.0 = off)")
    args = ap.parse_args(argv)
    device = pick_device(args.cpu)
    base, camera = pose_scene(args.goat, args.tris, device)
    out = fit_pose(base, camera, args.steps, args.size, args.spp, args.depth, args.lr,
                   args.eps, args.screen, args.occlusion, args.coarse, args.init, device)
    out.update(ok=out["error_end"] <= BAR, **card_info(device))
    if not out["ok"]:
        print("WARNING: pose did not converge", file=sys.stderr)
    else:
        print("converged")
    return out


def main(argv=None) -> int:
    return 0 if run(argv)["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
