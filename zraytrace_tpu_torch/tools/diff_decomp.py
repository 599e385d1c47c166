"""Where the time of one fit step goes: the step timed in variants that
each take one suspect away.

Counterpart of ``tools/diff_decomp.py``. The default workload is
``tools/diff_bench.py``'s ``sphere_albedo_fit`` (scene 1 at 128x128, 8
spp, depth 10, gradients into every leaf of the scene, a black target):

    full             the step: the loss and its backward           [base]
    value_only       the forward alone, no graph                [forward]
    no_edge          no edge factors                         [edge share]
    no_branch        no REINFORCE term of the Fresnel branch   [branch]
    no_remat         each bounce kept, not recomputed, one
                     trace_paths call per sample                [remat]
    no_atlas         every leaf but the atlas                  [atlas]
    geom_only        sphere centers and radii only
    flat_samples     all samples as extra lanes in one trace_paths call,
                     without the per-sample baseline (``render_diff``
                     traces its samples as lanes too, with it)
    nearest_tex      nearest texels, one fetch per hit in place of four
    flat_restricted  the fit's fields (centers, radii, tex_color), flat

``--teapot`` decomposes ``teapot_pose_fit`` (the teapot on the ground, by
default 64x64, 8 spp, depth 4, the pose offset from
``kernel_inputs.POSE_START``):
``value_only``, ``full``, ``no_edge``, ``one_eps``, ``occl_on`` (the
occlusion term on camera segments) and ``screen`` (screen-space margins
at 5e-4); on the card every bounce launches the flash kernel and, with
edge factors, the margin kernel.

The variants are ``trace_paths``' own arguments (``edge_eps``,
``branch_grad``, ``remat``, ``bilinear_textures``) and the set of leaves
that require grad. Each variant: one untimed step, then the mean of
``--steps`` steps on the host clock, the card synchronised before and
after.

    python -m zraytrace_tpu_torch.tools.diff_decomp [--cpu] [--steps 5]
        [--size 128] [--spp 8] [--depth 10] [--teapot]
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from zraytrace_tpu_torch.tools.common import card_info, pick_device, sync

__all__ = ["SPHERE_VARIANTS", "TEAPOT_VARIANTS", "timed", "sphere_decomp", "teapot_decomp",
           "main"]

SPHERE_VARIANTS = ("value_only", "full", "no_edge", "no_branch", "no_remat", "no_atlas",
                   "geom_only", "flat_samples", "nearest_tex", "flat_restricted")
TEAPOT_VARIANTS = ("value_only", "full", "no_edge", "one_eps", "occl_on", "screen")
SEED = 42
EDGE = (0.01, 0.02)
FIT_FIELDS = ("sph_center", "sph_radius", "tex_color")


def timed(step, device, steps: int) -> dict:
    """``step()`` once untimed, then ``steps`` times: the first step's
    seconds and the mean of the rest, the card synchronised around
    each."""
    sync(device)
    t0 = time.perf_counter()
    step()
    sync(device)
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(steps):
        step()
    sync(device)
    return dict(step_seconds=(time.perf_counter() - t0) / steps, first_step_seconds=first)


def sphere_decomp(device, size: int = 128, spp: int = 8, depth: int = 10, steps: int = 5,
                  variants=SPHERE_VARIANTS, verbose: bool = True) -> dict:
    from zraytrace_tpu_torch import vecmath as vm
    from zraytrace_tpu_torch.inverse import image_loss, merge_scene, split_scene
    from zraytrace_tpu_torch.render_diff import render_diff, trace_paths
    from zraytrace_tpu_torch.scenes import build_scene

    device = torch.device(device)
    built = build_scene(1, device)
    camera = built.camera
    params, static = split_scene(built.scene)
    target = torch.zeros((size, size, 3), dtype=torch.float32, device=device)
    n = size * size
    pixel_ids = torch.arange(n, dtype=torch.int32, device=device)

    def image(s, edge=EDGE, branch=True, remat=True, flat=False, bilinear=True):
        if not flat and remat:
            return render_diff(s, camera, size, size, spp, depth, seed=SEED, edge_eps=edge,
                               branch_grad=branch, bilinear_textures=bilinear)
        if flat:
            pix = pixel_ids.repeat(spp)
            samp = torch.arange(spp, dtype=torch.int32, device=device).repeat_interleave(n)
            r = trace_paths(s, camera, pix, samp, SEED, size, size, depth, edge_eps=edge,
                            remat=remat, branch_grad=branch)
            return vm.div(r.reshape(spp, n, 3).sum(0), float(spp)).reshape(size, size, 3)
        total = torch.zeros((n, 3), dtype=torch.float32, device=device)
        for k in range(spp):
            total = total + trace_paths(
                s, camera, pixel_ids, torch.full((n,), k, dtype=torch.int32, device=device),
                SEED, size, size, depth, edge_eps=edge, remat=remat, branch_grad=branch)
        return vm.div(total, float(spp)).reshape(size, size, 3)

    def step_fn(live, grad=True, **kw):
        """One step: the loss with ``live`` leaves requiring grad, and its
        backward (or the forward alone, without a graph)."""
        def step():
            p = {f: (v.detach().requires_grad_(grad) if f in live else v.detach())
                 for f, v in params.items()}
            with torch.set_grad_enabled(grad):
                loss = image_loss(image(merge_scene(p, static), **kw), target)
                if grad:
                    loss.backward()
            return loss
        return step

    every = tuple(params)
    table = {
        "value_only": step_fn(every, grad=False),
        "full": step_fn(every),
        "no_edge": step_fn(every, edge=None),
        "no_branch": step_fn(every, branch=False),
        "no_remat": step_fn(every, remat=False),
        "no_atlas": step_fn(tuple(f for f in every if f != "atlas")),
        "geom_only": step_fn(("sph_center", "sph_radius")),
        "flat_samples": step_fn(every, flat=True),
        "nearest_tex": step_fn(every, bilinear=False),
        "flat_restricted": step_fn(FIT_FIELDS, flat=True),
    }
    return _run(table, variants, device, steps, verbose)


def teapot_decomp(device, size: int = 64, spp: int = 8, depth: int = 4, steps: int = 5,
                  variants=TEAPOT_VARIANTS, verbose: bool = True) -> dict:
    from zraytrace_tpu_torch.geometry.bvh import build_tri_bvh
    from zraytrace_tpu_torch.kernel_inputs import POSE_START, pose_image
    from zraytrace_tpu_torch.scenes import teapot_on_ground

    device = torch.device(device)
    b = teapot_on_ground(device)
    base, camera = b.scene, b.camera
    order = build_tri_bvh(base.tri_a, base.tri_b, base.tri_c).prim_order.to(device)
    zero = torch.zeros(3, dtype=torch.float32, device=device)
    dims = dict(width=size, height=size, spp=spp, depth=depth)
    with torch.no_grad():
        target = pose_image(base, camera, order, zero, None, **dims)
    off0 = torch.tensor(POSE_START, dtype=torch.float32, device=device)

    def step_fn(eps, grad=True, occlusion=False, screen=False, pair=True):
        """One step of the pose loss, edge factors at (eps, 2 eps), or eps
        alone without ``pair``."""
        def step():
            off = off0.clone().requires_grad_(grad)
            with torch.set_grad_enabled(grad):
                img = pose_image(base, camera, order, off, eps, screen, occlusion, pair=pair,
                                 **dims)
                loss = ((img - target) ** 2).mean()
                if grad:
                    loss.backward()
            return loss
        return step

    table = {
        "value_only": step_fn(0.015, grad=False),
        "full": step_fn(0.015),
        "no_edge": step_fn(None),
        "one_eps": step_fn(0.015, pair=False),
        "occl_on": step_fn(0.015, occlusion="camera"),
        "screen": step_fn(5e-4, screen=True),
    }
    return _run(table, variants, device, steps, verbose)


def _run(table: dict, variants, device, steps: int, verbose: bool) -> dict:
    unknown = [v for v in variants if v not in table]
    if unknown:
        raise ValueError(f"unknown variants {unknown}; choose from {list(table)}")
    out = {}
    for name in variants:
        out[name] = timed(table[name], device, steps)
        if verbose:
            print(f"{name:16s} {out[name]['step_seconds'] * 1e3:10.1f} ms/step "
                  f"(first {out[name]['first_step_seconds']:.2f} s)", flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m zraytrace_tpu_torch.tools.diff_decomp")
    ap.add_argument("--cpu", action="store_true", help="run on the host, not the card")
    ap.add_argument("--size", type=int, default=None, help="128, or 64 with --teapot")
    ap.add_argument("--spp", type=int, default=8)
    ap.add_argument("--depth", type=int, default=None, help="10, or 4 with --teapot")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--teapot", action="store_true")
    ap.add_argument("--variants", nargs="*", default=None)
    args = ap.parse_args(argv)
    device = pick_device(args.cpu)
    if args.teapot:
        out = teapot_decomp(device, args.size or 64, args.spp, args.depth or 4, args.steps,
                            args.variants or TEAPOT_VARIANTS)
    else:
        out = sphere_decomp(device, args.size or 128, args.spp, args.depth or 10, args.steps,
                            args.variants or SPHERE_VARIANTS)
    print(json.dumps({"diff_decomp": out, "workload": "teapot_pose_fit" if args.teapot else
                      "sphere_albedo_fit", **card_info(device)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
