"""Differentiable-path benchmark: the time of a fit step and its effective
ray rate, on two workloads.

Counterpart of ``tools/diff_bench.py``:

- ``sphere_albedo_fit``: scene 1 (threeBalls, the 7-spheres showcase)
  toward a black target through ``render_diff`` with edge factors at
  ``(0.01, 0.02)``, Adam at lr 1e-2 over ``sph_center``, ``sph_radius`` and
  ``tex_color`` (the other leaves frozen), default 128x128, 8 spp, depth
  10; then, with ``all_leaves``, the same step over every leaf
  (``step_seconds_all_leaves``);
- ``teapot_pose_fit``: the 6,320-triangle teapot on the ground sphere
  (``scenes.teapot_on_ground``), from the offset ``POSE_START`` toward its
  image at offset 0, edge factors at ``(0.015, 0.03)`` without the
  occlusion term, flash planes repacked each step in the BVH order, Adam
  at lr 2e-2, default 64x64, 8 spp, depth 4. On the card each step's
  forward launches the flash and margin kernels depth x sample groups
  times each (``render_diff.sample_groups``: one group at 64x64x8).

The steps are the port's own: the sphere step is ``inverse.make_loss_fn``
(``fit()``'s loss) under Adam as ``fit()`` builds it, the pose step
``kernel_inputs.pose_adam_step``, which ``chip_smoke.py`` phase 10 holds
to the plain route. ``rays_forward`` is ``render()``'s ray count at the
initial parameters, seed and shapes: the RNG is a stateless hash of
(pixel, sample, bounce), so the first step's forward traces the same
paths (later steps move the scene, and their counts drift).

Timing: one untimed step (``first_step_seconds``, the counterpart of the
JAX tool's ``compile_seconds``), then ``steps`` steps, each on the host
clock between synchronises of the card. ``step_seconds`` is their median
(``step_seconds_mean``, ``_min``, ``_max``, ``spread_pct`` and the list
beside it); ``eff_rays_per_s = rays_forward / step_seconds``,
``pixel_samples_per_s = size^2 spp / step_seconds``, and
``eff_rays_per_s_window`` all the timed steps' forward rays over all their
seconds. Each step is checked:
a finite loss, finite gradients, and on the card the kernels' launches.

    python -m zraytrace_tpu_torch.tools.diff_bench [--cpu] [--steps 10]
        [--out DIFF_BENCH_TORCH.json]

writes the port's report (never the reference's ``DIFF_BENCH.json``) with
the card's name and power limit, the host's CPU model, the torch version
and the wall time, and prints one JSON line; exits 1 if a check failed.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import sys
import time
from pathlib import Path

import torch

from zraytrace_tpu_torch.tools.common import card_info, pick_device, sync

__all__ = ["SEED", "SPHERE", "TEAPOT", "SPHERE_EDGE", "SPHERE_LR", "FIT_FIELDS",
           "sphere_albedo_step", "time_steps", "bench_sphere_albedo",
           "bench_teapot_pose", "compute_report", "last_line", "cpu_model", "main"]

SEED = 42
SPHERE = dict(size=128, spp=8, depth=10)
TEAPOT = dict(size=64, spp=8, depth=4)
SPHERE_EDGE = (0.01, 0.02)
SPHERE_LR = 1e-2
FIT_FIELDS = ("sph_center", "sph_radius", "tex_color")  # BASELINE configs[4]


def sphere_albedo_step(device, size: int, spp: int, depth: int, seed: int = SEED,
                       fields=FIT_FIELDS):
    """The sphere-albedo fit's Adam step over ``fields`` of scene 1, the
    rest frozen (the pose fit's is ``kernel_inputs.pose_adam_step``).
    Returns ``(step, live, scene, camera)``: ``step()`` takes a step and
    returns its loss; ``live`` maps each field to its leaf, whose ``grad``
    holds the last step's gradient; the scene and camera are the fit's
    start."""
    from zraytrace_tpu_torch.inverse import make_loss_fn, split_scene
    from zraytrace_tpu_torch.scenes import build_scene

    built = build_scene(1, device)
    params, static = split_scene(built.scene)
    live = {f: params[f].detach().clone().requires_grad_(True) for f in fields}
    frozen = {**static, **{f: v for f, v in params.items() if f not in live}}
    target = torch.zeros((size, size, 3), dtype=torch.float32, device=device)
    loss_fn = make_loss_fn(frozen, built.camera, target, size, size, spp, depth, seed,
                           edge_eps=SPHERE_EDGE)
    opt = torch.optim.Adam(list(live.values()), lr=SPHERE_LR, betas=(0.9, 0.999), eps=1e-8)

    def step():
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(live)
        loss.backward()
        opt.step()
        return loss.detach()

    return step, live, built.scene, built.camera


def _launches() -> tuple:
    from zraytrace_tpu_torch.profiling import counter

    return tuple(counter(k) for k in ("launch.bounce", "launch.flash", "launch.margins"))


def time_steps(step, live: dict, device, steps: int) -> dict:
    """One untimed step, then ``steps`` steps each on the host clock
    between synchronises: the times, each step's losses and kernel
    launches (bounce, flash, margins), and whether every loss and
    gradient was finite."""
    if steps < 1:
        raise ValueError(f"steps must be at least 1, not {steps}")
    device = torch.device(device)
    sync(device)
    t0 = time.perf_counter()
    loss = step()
    sync(device)
    first = time.perf_counter() - t0
    losses, seconds, launches = [float(loss)], [], []
    finite = math.isfinite(losses[0])
    for _ in range(steps):
        before = _launches()
        sync(device)
        t0 = time.perf_counter()
        loss = step()
        sync(device)
        seconds.append(time.perf_counter() - t0)
        launches.append([a - b for a, b in zip(_launches(), before)])
        losses.append(float(loss))
        # a leaf the loss does not reach (a sphere scene's triangles) has none
        grads = [p.grad for p in live.values() if p.grad is not None]
        finite = (finite and math.isfinite(losses[-1]) and bool(grads)
                  and all(bool(torch.isfinite(g).all()) for g in grads))
    return dict(first_step_seconds=first, seconds=seconds, losses=losses, launches=launches,
                finite=finite)


def _step_stats(t: dict, rays: int, pixel_samples: int) -> dict:
    s = t["seconds"]
    med = statistics.median(s)
    return dict(step_seconds=med, step_seconds_mean=statistics.fmean(s),
                step_seconds_min=min(s), step_seconds_max=max(s),
                spread_pct=100.0 * (max(s) - min(s)) / med if len(s) > 1 else 0.0,
                step_seconds_list=s, first_step_seconds=t["first_step_seconds"],
                eff_rays_per_s=rays / med, pixel_samples_per_s=pixel_samples / med,
                eff_rays_per_s_window=rays * len(s) / sum(s))


def _forward_rays(scene, camera, size: int, spp: int, depth: int, seed: int, device) -> tuple:
    """``render()``'s ray count at these parameters, and whether its
    counters hold the samples identities."""
    from zraytrace_tpu_torch.config import RenderParams
    from zraytrace_tpu_torch.render import render

    _, st = render(scene, camera, RenderParams(width=size, height=size, samples_per_pixel=spp,
                                               max_depth=depth, seed=seed), device)
    ok = (st.samples == size * size * spp
          and st.rays == st.reflections + st.samples - st.recursion_depth_hits)
    return st.rays, ok


def _checks(t: dict, identities: bool, device, per_step) -> dict:
    """The checks of one timed workload: finite losses and gradients, the
    samples identities of ``rays_forward``, and on the card every step's
    launches (bounce, flash, margins) equal to ``per_step``."""
    checks = dict(finite=t["finite"], rays_forward_identities=identities)
    if torch.device(device).type == "cuda":
        checks["launches"] = all(got == list(per_step) for got in t["launches"])
    return checks


def bench_sphere_albedo(size: int = SPHERE["size"], spp: int = SPHERE["spp"],
                        depth: int = SPHERE["depth"], steps: int = 10, seed: int = SEED,
                        device="cuda", all_leaves: bool = True) -> dict:
    """``tools/diff_bench.py:58`` on the port: the step over ``FIT_FIELDS``
    and, with ``all_leaves``, over every leaf. No kernel runs on a sphere
    scene's differentiable path, so every step launches none."""
    from zraytrace_tpu_torch.inverse import DIFF_FIELDS

    device = torch.device(device)
    step, live, scene, camera = sphere_albedo_step(device, size, spp, depth, seed)
    rays, identities = _forward_rays(scene, camera, size, spp, depth, seed, device)
    t = time_steps(step, live, device, steps)
    entry = dict(
        config=dict(scene="threeBalls(1)", width=size, height=size, spp=spp, depth=depth,
                    seed=seed, edge_eps=list(SPHERE_EDGE), lr=SPHERE_LR,
                    grads="sph_center + sph_radius + tex_color (the BASELINE configs[4] "
                          "recovery workload); _all_leaves adds IORs, vertices and atlas "
                          "texels"),
        rays_forward=rays, steps=steps, **_step_stats(t, rays, size * size * spp),
        loss_first=t["losses"][0], launches_per_step=t["launches"])
    checks = _checks(t, identities, device, (0, 0, 0))
    if all_leaves:
        step, live, _, _ = sphere_albedo_step(device, size, spp, depth, seed, DIFF_FIELDS)
        ta = time_steps(step, live, device, steps)
        sa = _step_stats(ta, rays, size * size * spp)
        entry.update(step_seconds_all_leaves=sa["step_seconds"],
                     step_seconds_all_leaves_list=sa["step_seconds_list"],
                     eff_rays_per_s_all_leaves=sa["eff_rays_per_s"])
        checks["all_leaves"] = _checks(ta, identities, device, (0, 0, 0))
    entry.update(checks=checks, correct=_all_true(checks))
    return entry


def bench_teapot_pose(size: int = TEAPOT["size"], spp: int = TEAPOT["spp"],
                      depth: int = TEAPOT["depth"], steps: int = 10, seed: int = SEED,
                      device="cuda") -> dict:
    """``tools/diff_bench.py:133`` on the port. ``seed`` must be
    ``kernel_inputs.SEED``, the pose step's."""
    from zraytrace_tpu_torch.geometry.bvh import build_tri_bvh
    from zraytrace_tpu_torch.kernel_inputs import (
        POSE_EPS,
        POSE_LR,
        POSE_START,
        pose_adam_step,
        pose_image,
    )
    from zraytrace_tpu_torch.kernel_inputs import SEED as POSE_SEED
    from zraytrace_tpu_torch.render_diff import sample_groups
    from zraytrace_tpu_torch.scenes import teapot_on_ground
    from zraytrace_tpu_torch.transforms import Pose, transform_triangles

    if seed != POSE_SEED:
        raise ValueError(f"the pose step renders with seed {POSE_SEED}, not {seed}")
    device = torch.device(device)
    b = teapot_on_ground(device)
    base, camera = b.scene, b.camera
    order = build_tri_bvh(base.tri_a, base.tri_b, base.tri_c).prim_order.to(device)
    dims = dict(width=size, height=size, spp=spp, depth=depth)
    with torch.no_grad():
        target = pose_image(base, camera, order, torch.zeros(3, device=device), POSE_EPS,
                            **dims)
    step, off = pose_adam_step(base, camera, order, target, **dims)
    with torch.no_grad():
        start = torch.tensor(POSE_START, dtype=torch.float32, device=device)
        scene0 = transform_triangles(base, Pose(start, torch.zeros(3, device=device),
                                                torch.ones((), device=device)))
    rays, identities = _forward_rays(scene0, camera, size, spp, depth, seed, device)
    t = time_steps(step, {"off": off}, device, steps)
    entry = dict(
        config=dict(scene="teapot+ground", triangles=int(base.n_triangles), width=size,
                    height=size, spp=spp, depth=depth, seed=seed,
                    edge_eps=[POSE_EPS, 2.0 * POSE_EPS], lr=POSE_LR, start=list(POSE_START),
                    grads="pose (translation) via winner-recompute mesh split + flash "
                          "winner pass"),
        rays_forward=rays, steps=steps, **_step_stats(t, rays, size * size * spp),
        loss_first=t["losses"][0], launches_per_step=t["launches"])
    per = depth * len(sample_groups(size * size, spp))
    checks = _checks(t, identities, device, (0, per, per))
    entry.update(checks=checks, correct=_all_true(checks))
    return entry


def _all_true(checks: dict) -> bool:
    return all(_all_true(v) if isinstance(v, dict) else bool(v) for v in checks.values())


WORKLOADS = {"sphere_albedo_fit": (bench_sphere_albedo, SPHERE),
             "teapot_pose_fit": (bench_teapot_pose, TEAPOT)}


def compute_report(device, steps: int = 10, sphere: dict = SPHERE, teapot: dict = TEAPOT) -> dict:
    """The report ``main`` writes: both workloads at these sizes, then the
    card's name and power limit, the host's CPU model, the torch version
    and the wall time. Each workload's summary goes to stderr."""
    t0 = time.perf_counter()
    report = {"workloads": {}}
    for name, dims in (("sphere_albedo_fit", sphere), ("teapot_pose_fit", teapot)):
        fn = WORKLOADS[name][0]
        entry = fn(dims["size"], dims["spp"], dims["depth"], steps, device=device)
        report["workloads"][name] = entry
        print(f"  {name}: {entry['step_seconds'] * 1e3:.1f} ms/step (median of {steps}; "
              f"spread {entry['spread_pct']:.1f}%), {entry['eff_rays_per_s'] / 1e6:.4f}M "
              f"eff rays/s (fwd rays {entry['rays_forward']}); checks {entry['checks']}",
              file=sys.stderr, flush=True)
    report["wall_seconds"] = time.perf_counter() - t0
    report.update(card_info(device), cpu_model=cpu_model(), torch_version=torch.__version__)
    return report


def last_line(report: dict) -> dict:
    """The line ``main`` prints last (``tools/diff_bench.py:253-258``, with
    the device); its metric is ``_cpu``-suffixed off the card."""
    w = report["workloads"]
    suffix = "_cpu" if report["device"] == "cpu" else ""
    return {"metric": "diff_step_eff_rays_per_s" + suffix,
            "value": w["sphere_albedo_fit"]["eff_rays_per_s"], "unit": "rays/s (fwd+bwd)",
            "teapot_pose_fit": w["teapot_pose_fit"]["eff_rays_per_s"],
            "device": report["device"]}


def cpu_model() -> str | None:
    """The host CPU's model name from ``/proc/cpuinfo`` (its first
    processor), or None. Where a virtual machine reports the name as
    unknown, the vendor, family, model and stepping numbers stand beside
    it; the count of logical CPUs follows either."""
    fields: dict = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if not line.strip():
                    if fields:
                        break
                    continue
                key, _, value = line.partition(":")
                fields.setdefault(key.strip(), value.strip())
    except OSError:
        return None
    if not fields:
        return None
    name = fields.get("model name", "unknown")
    if name.lower() == "unknown":
        name += " (" + ", ".join(f"{k} {fields[k]}" for k in (
            "vendor_id", "cpu family", "model", "stepping") if k in fields) + ")"
    return f"{name}; {os.cpu_count()} logical CPUs"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m zraytrace_tpu_torch.tools.diff_bench")
    ap.add_argument("--cpu", action="store_true", help="run on the host, not the card")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--out", default="DIFF_BENCH_TORCH.json")
    args = ap.parse_args(argv)
    if Path(args.out).name == "DIFF_BENCH.json":
        raise SystemExit("DIFF_BENCH.json is the JAX package's record; write the port's "
                         "elsewhere (default DIFF_BENCH_TORCH.json)")
    report = compute_report(pick_device(args.cpu), args.steps)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(last_line(report)))
    return 0 if all(e["correct"] for e in report["workloads"].values()) else 1


if __name__ == "__main__":
    raise SystemExit(main())
