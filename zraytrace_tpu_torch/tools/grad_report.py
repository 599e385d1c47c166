"""Gradient-quality report: per parameter class, the largest relative
error of ``render_diff``'s gradient against central finite differences.

Counterpart of ``tools/grad_report.py`` (its ``CLASSES``, ``TARGET_SHIFT``,
``PASS_THRESHOLD`` and ``compute_report``), on the port. The RNG is a
stateless hash of (pixel, sample, bounce), so the loss is deterministic
and central differences over the same sample streams measure the true
derivative, visibility included; for boundary-dominated parameters the FD
steps are paired with the edge estimator's bandwidths and averaged. Each
class runs on the reference's probe scene for it: a Lambertian sphere for
center, radius and camera pose, a Lambertian triangle for a vertex, a red
sphere behind a glass one for albedo and IOR.

``ior`` is the correlated-FD hybrid (``inverse.fd_gradients``'s estimator
at an independent step, 0.004) that the JAX package ships for a
dielectric's IOR; ``ior_analytic`` records the analytic estimator beside
it, as in the reference. ``camera_pose`` differentiates ``look_from``
through ``camera.make_camera``. The JAX tool's jitted functions are the
port's eager ``render_diff``.

    python -m zraytrace_tpu_torch.tools.grad_report [--cpu] [--size 64]
        [--spp 128] [--seeds 5] [--out GRAD_REPORT_TORCH.json]

writes the port's report (never the reference's ``GRAD_REPORT.json``),
with the device's name and power limit, and prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from zraytrace_tpu_torch import scene as sc
from zraytrace_tpu_torch.camera import make_camera
from zraytrace_tpu_torch.inverse import image_loss, merge_scene, split_scene
from zraytrace_tpu_torch.render_diff import render_diff
from zraytrace_tpu_torch.tools.common import card_info, pick_device

__all__ = ["CLASSES", "TARGET_SHIFT", "PASS_THRESHOLD", "HYBRID_STEP", "compute_report",
           "class_errors", "main"]

SPHERE_EPS = (0.01, 0.02)
TRI_EPS = (0.005, 0.01)
LOOK_AT, VUP, VFOV = (0.0, 0.0, 1.0), (0.0, 1.0, 0.0), 45.0
LOOK_FROM = (0.0, 0.0, -2.0)
HYBRID_STEP = 0.004  # the shipped IOR estimator's independent FD step


def _sphere_scene(b: sc.SceneBuilder) -> None:
    b.add_sphere((0.45, 0.3, 5.0), 1.0, b.add_lambertian_color((0.8, 0.1, 0.1)))


def _triangle_scene(b: sc.SceneBuilder) -> None:
    tris = np.asarray([[[-1.0, -0.8, 5.0], [0.0, 1.2, 5.0], [1.0, -0.8, 5.0]]], np.float32)
    b.add_triangles(tris[:, 0], tris[:, 1], tris[:, 2], b.add_lambertian_color((0.8, 0.1, 0.1)))


def _material_scene(b: sc.SceneBuilder) -> None:
    """A red sphere behind a glass sphere: the IOR bends what the camera
    sees of the red one, tex_color drives the albedo."""
    red = b.add_lambertian_color((0.8, 0.2, 0.1))
    green = b.add_lambertian_color(sc.COLOR_GREEN)
    glass = b.add_dielectric(1.52)
    b.add_sphere((0.0, 0.0, 5.0), 1.2, red)
    b.add_sphere((0.0, -51.0, 5.0), 50.0, green)
    b.add_sphere((0.0, 0.0, 2.2), 0.7, glass)


# class -> (scene, field (None: look_from), component indices, edge
# bandwidths, FD steps, (spp, depth) factors), as tools/grad_report.py:106
CLASSES = {
    "sphere_center": (_sphere_scene, "sph_center", [(0, 0), (0, 2)],
                      SPHERE_EPS, (0.01, 0.02), (4.0, 3)),
    "sphere_radius": (_sphere_scene, "sph_radius", [(0,)],
                      SPHERE_EPS, (0.01, 0.02), (1.0, 3)),
    "triangle_vertex": (_triangle_scene, "tri_b", [(0, 1), (0, 0)],
                        TRI_EPS, (0.02, 0.03), (1.0, 2)),
    "albedo": (_material_scene, "tex_color", [(0, 0), (0, 1)],
               SPHERE_EPS, (2e-3,), (0.5, 4)),
    "ior": (_material_scene, "mat_ior", [(2,)],
            SPHERE_EPS, (0.01, 0.02), (2.0, 4)),
    "camera_pose": (_sphere_scene, None, [(0,), (1,)],
                    SPHERE_EPS, (0.01, 0.02), (4.0, 3)),
}

# lateral classes render their target at shifted parameters with another
# seed, so every probed component has an O(1) pull (tools/grad_report.py:130)
TARGET_SHIFT = {
    "sphere_center": (0.25, 0.1, -0.35),
    "camera_pose": (0.2, -0.15, 0.0),
}

PASS_THRESHOLD = 0.10  # per class: mean over seeds of the largest relative error


def class_errors(g_vals, fd_vals) -> float:
    """The largest relative error of gradients against FD values, each
    floored at a fifth of the class's largest |FD| so that a near-zero
    component's noise does not read as a large error."""
    g = np.asarray(g_vals, np.float64)
    fd = np.asarray(fd_vals, np.float64)
    scale = max(np.abs(fd).max(), 1e-9)
    return float((np.abs(g - fd) / np.maximum(np.abs(fd), 0.2 * scale)).max())


def compute_report(width=64, height=64, spp=128, seed=42, verbose=True, classes=None,
                   n_seeds=5, device="cuda") -> dict:
    """Every class of ``classes`` (all by default) over ``n_seeds`` sets
    of sample streams (seeds ``seed + 101 * i``): per class the mean,
    spread and worst of the per-seed errors, the first seed's gradient
    and FD values, and whether the mean passes ``PASS_THRESHOLD``."""
    device = torch.device(device)
    seeds = [seed + 101 * i for i in range(n_seeds)]
    report = {"config": dict(width=width, height=height, spp=spp, seeds=seeds,
                             edge_aware=True, pass_threshold=PASS_THRESHOLD),
              "classes": {}}
    acc: dict[str, list] = {}

    def entry(name, g_vals, fd_vals):
        acc.setdefault(name, []).append(dict(
            rel=class_errors(g_vals, fd_vals), grad=[float(x) for x in g_vals],
            fd=[float(x) for x in fd_vals]))

    def finalize(name):
        rels = np.asarray([s["rel"] for s in acc[name]])
        report["classes"][name] = dict(
            max_rel_error=float(rels.mean()),
            rel_error_per_seed=[round(float(r), 6) for r in rels],
            rel_error_spread=float(rels.std()),
            rel_error_worst_seed=float(rels.max()),
            passes=bool(rels.mean() <= PASS_THRESHOLD),
            grad=acc[name][0]["grad"], fd=acc[name][0]["fd"])
        if verbose:
            print(f"  {name:16s} rel_error mean={rels.mean():.4f} +- {rels.std():.4f} "
                  f"(worst seed {rels.max():.4f}, {len(rels)} seeds)", file=sys.stderr,
                  flush=True)

    for name, (build, field, idxs, eps, fd_steps, (sppf, depth)) in CLASSES.items():
        if classes is not None and name not in classes:
            continue
        b = sc.SceneBuilder()
        build(b)
        params, static = split_scene(b.build(device))
        lf = torch.tensor(LOOK_FROM, dtype=torch.float32)
        cspp = max(2, int(round(spp * sppf)))

        def image(p, look_from, seed_, e):
            cam = make_camera(look_from, LOOK_AT, VUP, VFOV, 1.0, device=device)
            return render_diff(merge_scene(p, static), cam, width, height, cspp, depth,
                               seed=seed_, edge_eps=e)

        shift = TARGET_SHIFT.get(name)
        with torch.no_grad():
            if shift is None:
                target = torch.zeros((height, width, 3), dtype=torch.float32, device=device)
            else:
                dv = torch.tensor(shift, dtype=torch.float32)
                if field is None:
                    p_t, lf_t = params, lf + dv
                else:
                    p_t = {**params, field: params[field] + dv.to(device)[None, :]}
                    lf_t = lf
                target = image(p_t, lf_t, seed + 9999, None)

        def loss_plain(p, look_from, seed_):
            with torch.no_grad():
                return float(image_loss(image(p, look_from, seed_, None), target))

        def perturb(idx, h):
            x = (lf if field is None else params[field]).clone()
            x[idx] += h
            return (params, x) if field is None else ({**params, field: x}, lf)

        def gradient(seed_):
            """The analytic gradient of the probed leaf, at the class's
            edge bandwidths."""
            if field is None:
                x = lf.clone().requires_grad_(True)
                image_loss(image(params, x, seed_, eps), target).backward()
                return x.grad.numpy()
            x = params[field].detach().clone().requires_grad_(True)
            image_loss(image({**params, field: x}, lf, seed_, eps), target).backward()
            return x.grad.cpu().numpy()

        for sd in seeds:
            g_all = gradient(sd)
            g_vals, fd_vals = [], []
            for idx in idxs:
                g_vals.append(float(g_all[idx[0] if field is None else idx]))
                fds = [(loss_plain(*perturb(idx, +h), sd) - loss_plain(*perturb(idx, -h), sd))
                       / (2 * h) for h in fd_steps]
                fd_vals.append(float(np.mean(fds)))
            if name == "ior":
                entry("ior_analytic", g_vals, fd_vals)
                hy_vals = [(loss_plain(*perturb(idx, +HYBRID_STEP), sd)
                            - loss_plain(*perturb(idx, -HYBRID_STEP), sd)) / (2 * HYBRID_STEP)
                           for idx in idxs]
                entry(name, hy_vals, fd_vals)
            else:
                entry(name, g_vals, fd_vals)
        finalize(name)
        if name == "ior":
            finalize("ior_analytic")

    # the overall figure covers the shipped estimator of each class;
    # ior_analytic rides beside it
    report["max_rel_error_overall"] = float(max(
        c["max_rel_error"] for k, c in report["classes"].items() if k != "ior_analytic"))
    if "ior_analytic" in report["classes"]:
        report["ior_analytic_max_rel_error"] = report["classes"]["ior_analytic"]["max_rel_error"]
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m zraytrace_tpu_torch.tools.grad_report")
    ap.add_argument("--cpu", action="store_true", help="run on the host, not the card")
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--spp", type=int, default=128)
    ap.add_argument("--seeds", type=int, default=5, help="sets of sample streams per class")
    ap.add_argument("--classes", nargs="*", choices=tuple(CLASSES), default=None)
    ap.add_argument("--out", default="GRAD_REPORT_TORCH.json")
    args = ap.parse_args(argv)
    if args.out == "GRAD_REPORT.json":
        raise SystemExit("GRAD_REPORT.json is the JAX package's report; write the port's "
                         "elsewhere (default GRAD_REPORT_TORCH.json)")
    device = pick_device(args.cpu)
    t0 = time.perf_counter()
    report = compute_report(width=args.size, height=args.size, spp=args.spp,
                            classes=args.classes, n_seeds=args.seeds, device=device)
    report["wall_seconds"] = time.perf_counter() - t0
    report["n_seeds"] = args.seeds
    report.update(card_info(device))
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps({"metric": "grad_vs_fd_max_rel_error",
                      "value": report["max_rel_error_overall"], "unit": "relative",
                      "per_class": {k: v["max_rel_error"]
                                    for k, v in report["classes"].items()},
                      "device": report["device"], "power_limit": report["power_limit"],
                      "wall_seconds": report["wall_seconds"]}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
