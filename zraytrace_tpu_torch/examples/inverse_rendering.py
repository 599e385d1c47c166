"""Inverse rendering: recover a perturbed sphere's center and radius and a
material's albedo from a target image by gradient descent.

Counterpart of ``examples/inverse_rendering.py``: a matte red ball on a
green ground, the target rendered by ``render_diff`` at the true
parameters (seed 5), the ball moved by (0.3, -0.25, 0.2), shrunk to 3/4
and given a wrong albedo, then ``inverse.fit`` (Adam, lr 8e-3) with edge
factors at 0.02 for the coverage gradients of center and radius, or with
correlated central differences for them (``--fd``). Recovery is OK when
the last loss is below a quarter of the first.

    python -m zraytrace_tpu_torch.examples.inverse_rendering [--steps 150]
        [--size 24] [--spp 8] [--fd] [--out PREFIX] [--cpu]
"""

from __future__ import annotations

import argparse

import torch

from zraytrace_tpu_torch.tools.common import card_info, pick_device, wall

__all__ = ["DEPTH", "SEED", "truth_scene", "run", "main"]

DEPTH = 4
SEED = 5
FIELDS = ("sph_center", "sph_radius", "tex_color")


def truth_scene(device):
    """The ground truth: a matte red ball on a green ground, and the
    camera."""
    from zraytrace_tpu_torch import scene as sc
    from zraytrace_tpu_torch.camera import make_camera

    b = sc.SceneBuilder()
    red = b.add_lambertian_color((0.8, 0.2, 0.1))
    green = b.add_lambertian_color(sc.COLOR_GREEN)
    b.add_sphere((0.0, 0.0, 3.0), 1.2, red)
    b.add_sphere((1.0, -52.0, 4.0), 50.0, green)
    camera = make_camera((0, 0, -5.0), (0, 0, 1.0), (0, 1.0, 0), 45.0, 1.0, device=device)
    return b.build(device), camera


def run(argv=None) -> dict:
    """Parse ``argv`` and run the recovery: returns the losses, the target
    image, the recovered values, ``ok``, the wall seconds and the device."""
    ap = argparse.ArgumentParser(prog="python -m zraytrace_tpu_torch.examples.inverse_rendering")
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--size", type=int, default=24)
    ap.add_argument("--spp", type=int, default=8)
    ap.add_argument("--cpu", action="store_true", help="run on the host, not the card")
    ap.add_argument("--out", default=None, help="write before/after PNGs")
    ap.add_argument("--fd", action="store_true",
                    help="correlated finite differences for the coverage gradients "
                         "instead of edge factors")
    args = ap.parse_args(argv)
    device = pick_device(args.cpu)

    from zraytrace_tpu_torch.inverse import fit, merge_scene, split_scene
    from zraytrace_tpu_torch.render_diff import render_diff

    truth, camera = truth_scene(device)
    w = h = args.size
    with torch.no_grad():
        target = render_diff(truth, camera, w, h, args.spp, DEPTH, seed=SEED)

    # the perturbation in numpy f32, as the JAX example makes it
    params, static = split_scene(truth)
    centers, radii, colors = (params[f].cpu().numpy().copy() for f in FIELDS)
    centers[0] += (0.3, -0.25, 0.2)
    radii[0] *= 0.75
    colors[0] = (0.3, 0.5, 0.8)
    broken = merge_scene({**params, **{f: torch.from_numpy(x).to(device) for f, x in
                                       zip(FIELDS, (centers, radii, colors))}}, static)

    result, seconds = wall(lambda: fit(
        broken, camera, target, w, h, spp=args.spp, max_depth=DEPTH, steps=args.steps,
        learning_rate=8e-3, seed=SEED, optimize_fields=FIELDS,
        fd_fields=("sph_center", "sph_radius") if args.fd else (),
        edge_eps=None if args.fd else 0.02, device=device), device)

    losses = result.losses.cpu().numpy()
    rec_c = result.scene.sph_center[0].cpu().numpy()
    rec_r = float(result.scene.sph_radius[0])
    rec_col = result.scene.tex_color[0].cpu().numpy()
    dev = card_info(device)
    print(f"loss: {losses[0]:.5f} -> {losses[-1]:.5f} ({args.steps} steps, {seconds:.2f} s, "
          f"{seconds / max(args.steps, 1):.3f} s/step on {dev['device']})")
    print(f"center:  true (0.00, 0.00, 3.00)  recovered ({rec_c[0]:+.3f}, {rec_c[1]:+.3f}, "
          f"{rec_c[2]:+.3f})")
    print(f"radius:  true 1.200               recovered {rec_r:.3f}")
    print(f"albedo:  true (0.80, 0.20, 0.10)  recovered ({rec_col[0]:.3f}, {rec_col[1]:.3f}, "
          f"{rec_col[2]:.3f})")

    if args.out:
        from zraytrace_tpu_torch.io.png import write_png

        with torch.no_grad():
            write_png(args.out + ".target.png", target.cpu().numpy())
            for tag, s in (("broken", broken), ("recovered", result.scene)):
                img = render_diff(s, camera, w, h, args.spp, DEPTH, seed=SEED)
                write_png(f"{args.out}.{tag}.png", img.cpu().numpy())

    ok = bool(losses[-1] < losses[0] * 0.25)
    print("RECOVERY", "OK" if ok else "INCOMPLETE")
    return dict(losses=losses, target=target.cpu(), center=rec_c, radius=rec_r,
                albedo=rec_col, ok=ok, seconds=seconds, steps=args.steps, **dev)


def main(argv=None) -> int:
    return 0 if run(argv)["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
