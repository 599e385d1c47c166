"""Headline benchmark of the port: rays per second of ``render()``'s engine
on the reference's two published scenes, and the fit steps'
effective ray rate.

Counterpart of ``bench.py`` (and, through ``--all``, of
``tools/diff_bench.py``). Prints one JSON line per cell:

- ``--scene 1``: threeBalls (7 spheres), 1000x1000, 1000 spp, depth 30,
  metric ``rays_per_second_7spheres_1000x1000``: one launch of the bounce
  kernel in sphere mode a pass;
- ``--scene 3``: the teapot, 700x700, 500 spp, depth 20, metric
  ``rays_per_second_teapot_700x700``: one launch in mesh mode a pass;
- ``--all``: those two, then ``sphere_albedo_fit`` and ``teapot_pose_fit``
  (``tools/diff_bench.py``'s workloads, without the all-leaves step),
  metrics ``diff_step_eff_rays_per_s_<workload>``.

A render cell runs ``render()``'s own code (``render.lanes``,
``render.mesh_routing``, ``render.trace_lanes``, ``render.fetch_sums`` and
``render.decode``) at
a ``sample_start`` of its own: one untimed warm-up of sample 0, one
untimed pass of samples ``[1, 1 + spp)``, then ``--repeats`` timed
passes of the same range. Each pass is timed on the host clock from a
synchronise to its counters' arrival on the host, with CUDA events
around the launch beside it (``device_ms``). The streams are keyed by
(pixel, sample), so every pass counts the same events. ``value`` is the
median pass's rays per second (with an even count, the slower of the two
middle passes), ``elapsed`` and ``device_ms`` that pass's,
``spread_pct`` the range of the passes' rates over ``value``,
``window_rate`` all the timed passes' rays over all their seconds (a fit
line's: its timed steps' forward rays over their seconds),
``vs_baseline`` ``value`` over the Zig tracer's rate
(``REF_RAYS_PER_SEC``, ``REF_TEAPOT_RAYS_PER_SEC``, the reference's
published runs).

Each line checks its own output, so that a wrong result never stands as
a rate (``"correct"``, ``"checks"``): the samples identities
(``samples == w h spp``, ``rays == reflections + samples -
recursion_depth_hits``), every pass's counters equal to the first's, on
the card one bounce launch a pass in the scene's mode; at the default
configurations, the event counts per sample against ``showcase/``'s
record (scene 1: within 1e-4 of its 1000x1000x1000 d30 row and a mean
8-bit difference below 0.5 from its PNG; scene 3: within 1e-3 of its
700x700x100 d20 row, the only teapot record, 49M samples whose rates'
sampling spread is about 1e-4). A cell that raises or fails a check
prints its line with ``"error"`` and the run exits 1.

The bench runs on the card and fails without one. ``--cpu`` runs the
plain wavefront on the host, for cut sizes only: every metric name gets a
``_cpu`` suffix and ``device`` says ``"cpu"``.

    python -m zraytrace_tpu_torch.bench [--scene 1|3] [--all] [--size N]
        [--spp N] [--depth N] [--seed 42] [--repeats 5] [--steps 10] [--cpu]

``--size``, ``--spp`` and ``--depth`` replace every chosen cell's own.
Diagnostics go to stderr.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import traceback
from typing import NamedTuple

import torch

from zraytrace_tpu_torch.tools.common import card_info, pick_device, sync

__all__ = ["REF_RAYS_PER_SEC", "REF_TEAPOT_RAYS_PER_SEC", "RENDER_CELLS", "FIT_CELLS", "CELLS",
           "Engine", "Pass", "render_engine", "run_pass", "bench_render", "render_line",
           "fit_line", "run_cell", "main"]

# The Zig tracer on one CPU thread (BASELINE.md): threeBalls at 1000x1000,
# 1000 spp, depth 30 in 617.41 s (README.md:58,61); the teapot,
# 425,784,511 rays in 36,069 s (scenes.zig:161-164). bench.py:21-23.
REF_RAYS_PER_SEC = 2_144_645_362 / 617.41
REF_TEAPOT_RAYS_PER_SEC = 425_784_511 / 36_069.0
UNIT = "rays/s/chip"
FIT_UNIT = "rays/s (fwd+bwd)"
SEED = 42


class RenderCell(NamedTuple):
    size: int
    spp: int
    depth: int
    metric: str
    baseline: float
    record_spp: int  # the showcase/SWEEP.md row held against
    event_tol: float  # per sample
    png: bool  # also hold the image to the record's PNG


RENDER_CELLS = {
    1: RenderCell(1000, 1000, 30, "rays_per_second_7spheres_1000x1000", REF_RAYS_PER_SEC,
                  1000, 1e-4, True),
    3: RenderCell(700, 500, 20, "rays_per_second_teapot_700x700", REF_TEAPOT_RAYS_PER_SEC,
                  100, 1e-3, False),
}
FIT_CELLS = ("sphere_albedo_fit", "teapot_pose_fit")
CELLS = ("scene1", "scene3") + FIT_CELLS  # --all, in this order


class Engine(NamedTuple):
    """``render()``'s engine for one scene and image size."""

    name: str
    scene: object
    camera: object
    route: object  # render.MeshRoute
    lay: object  # render.Lanes


class Pass(NamedTuple):
    counters: list  # render.N_COUNTERS ints
    seconds: float  # host clock, a synchronise to the counters on the host
    device_ms: float | None  # CUDA events around the launch
    launches: tuple  # bounce kernel launches, and those in mesh mode
    sums: torch.Tensor  # (n_slots, n_lanes, 3)


def render_engine(index: int, width: int, height: int, device) -> Engine:
    """Scene ``index`` at ``width`` x ``height`` on ``device``, routed and
    laid out on lanes by ``render()``'s own functions at
    ``RenderParams``' default ``max_wavefront``."""
    from zraytrace_tpu_torch.config import RenderParams
    from zraytrace_tpu_torch.render import lanes, mesh_routing
    from zraytrace_tpu_torch.scenes import build_scene

    device = torch.device(device)
    if device.type == "cuda":
        from zraytrace_tpu_torch.ops.bounce_kernel import library

        library()  # the build is set-up
    built = build_scene(index, device)
    return Engine(built.name, built.scene, built.camera, mesh_routing(built.scene, device),
                  lanes(width, height, RenderParams().max_wavefront, device))


def run_pass(e: Engine, seed: int, spp: int, depth: int, sample_start: int) -> Pass:
    """Samples ``[sample_start, sample_start + spp)`` of every pixel
    through ``render.trace_lanes``, timed."""
    from zraytrace_tpu_torch.profiling import counter
    from zraytrace_tpu_torch.render import trace_lanes

    def launches():
        return counter("launch.bounce"), counter("launch.bounce_mesh")

    dev = e.lay.base.device
    before = launches()
    events = None
    if dev.type == "cuda":
        events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    sync(dev)
    t0 = time.perf_counter()
    if events:
        events[0].record()
    sums, counters = trace_lanes(e.route, e.scene, e.camera, e.lay, seed, spp, depth,
                                 sample_start)
    if events:
        events[1].record()
    totals = counters.cpu().tolist()  # waits for the device
    seconds = time.perf_counter() - t0
    device_ms = events[0].elapsed_time(events[1]) if events else None
    after = launches()
    return Pass(totals, seconds, device_ms, (after[0] - before[0], after[1] - before[1]), sums)


def median_pass(passes: list) -> int:
    """The index of the median pass by rate (the slower of the two middle
    ones with an even count): every pass counts the same rays, so the
    median rate is the median time's."""
    order = sorted(range(len(passes)), key=lambda i: -passes[i].seconds)
    return order[(len(passes) - 1) // 2]


def render_line(metric: str, baseline: float, passes: list, device_info: dict) -> dict:
    """The JSON line of timed ``passes``: ``value`` the median pass's rays
    per second, ``elapsed`` and ``device_ms`` its time, ``spread_pct`` the
    range of the passes' rates over ``value``, ``window_rate`` all their
    rays over all their seconds."""
    from zraytrace_tpu_torch.render import C_RAYS, C_SAMPLES

    rays = passes[0].counters[C_RAYS]
    mid = passes[median_pass(passes)]
    value = rays / mid.seconds
    rates = [rays / p.seconds for p in passes]
    spread = 100.0 * (max(rates) - min(rates)) / value if len(passes) > 1 else 0.0
    return dict(metric=metric, value=value, unit=UNIT, passes=len(passes), spread_pct=spread,
                window_rate=rays * len(passes) / sum(p.seconds for p in passes),
                elapsed=mid.seconds, vs_baseline=value / baseline, device_ms=mid.device_ms,
                rays=rays, samples=passes[0].counters[C_SAMPLES], launches=mid.launches[0],
                pass_seconds=[p.seconds for p in passes],
                pass_device_ms=[p.device_ms for p in passes], **device_info)


def _suffix(device: torch.device) -> str:
    return "" if device.type == "cuda" else "_cpu"


def render_checks(e: Engine, cell: RenderCell, spp: int, depth: int, first: Pass,
                  passes: list) -> dict:
    """The render cell's checks of its own output (the module docstring)."""
    from zraytrace_tpu_torch import showcase
    from zraytrace_tpu_torch.render import (C_RAYS, C_RECURSION, C_REFLECTIONS, C_SAMPLES, decode,
                                            fetch_sums)

    c = first.counters
    w, h = e.lay.width, e.lay.height
    checks = dict(
        identities=(c[C_SAMPLES] == w * h * spp
                    and c[C_RAYS] == c[C_REFLECTIONS] + c[C_SAMPLES] - c[C_RECURSION]),
        passes_equal=all(p.counters == c for p in passes))
    if e.lay.base.device.type == "cuda":
        mesh = int(e.scene.n_triangles > 0)
        checks["launches"] = all(p.launches == (1, mesh) for p in [first, *passes])
    if (w, h, spp, depth) == (cell.size, cell.size, cell.spp, cell.depth):
        rec = showcase.record(e.name, w, h, cell.record_spp, depth)
        off = showcase.events_off(c[:4], c[C_SAMPLES], rec)
        checks.update(events_per_sample_off=off, events_bar=cell.event_tol,
                      events=off <= cell.event_tol)
        if cell.png:
            image = decode(fetch_sums(first.sums, e.lay), e.lay, spp)
            diff = showcase.mean_8bit_diff(image.numpy(), showcase.png(e.name, w, h, spp))
            checks.update(mean_8bit_diff=diff, png_bar=showcase.PNG_BAR,
                          image=diff < showcase.PNG_BAR)
    return checks


def bench_render(index: int, device, seed: int = SEED, repeats: int = 5, size: int | None = None,
                 spp: int | None = None, depth: int | None = None) -> dict:
    """One render cell: its JSON line (``correct`` and ``checks`` with the
    readings)."""
    if repeats < 1:
        raise ValueError(f"repeats must be at least 1, not {repeats}")
    device = torch.device(device)
    cell = RENDER_CELLS[index]
    size, spp, depth = size or cell.size, spp or cell.spp, depth or cell.depth
    t0 = time.perf_counter()
    e = render_engine(index, size, size, device)
    run_pass(e, seed, 1, depth, 0)  # warm-up: sample 0
    first = run_pass(e, seed, spp, depth, 1)  # untimed
    set_up = time.perf_counter() - t0
    passes = [run_pass(e, seed, spp, depth, 1) for _ in range(repeats)]
    for i, p in enumerate(passes):
        print(f"# pass {i}: {p.seconds:.6f} s, {p.counters[0] / p.seconds:.6g} rays/s, device "
              f"{p.device_ms} ms, launches {p.launches}", file=sys.stderr)
    line = render_line(cell.metric + _suffix(device), cell.baseline, passes, card_info(device))
    checks = render_checks(e, cell, spp, depth, first, passes)
    line.update(config=dict(scene=e.name, width=size, height=size, spp=spp, depth=depth,
                            seed=seed, lanes=e.lay.n_lanes, slots=e.lay.n_slots,
                            engine="bounce kernel" if e.route.kernel else "wavefront"),
                set_up_seconds=set_up, checks=checks,
                correct=all(v for k, v in checks.items() if isinstance(v, bool)))
    print(f"# {e.name} size={size} spp={spp} depth={depth} counters={first.counters} "
          f"elapsed={line['elapsed']:.6f}s device_ms={line['device_ms']} "
          f"set-up+warm={set_up:.3f}s passes={line['passes']} "
          f"spread={line['spread_pct']:.3f}% checks={checks} device={line['device']}",
          file=sys.stderr)
    return line


def fit_line(name: str, entry: dict, device_info: dict, suffix: str) -> dict:
    """The JSON line of a ``tools/diff_bench.py`` workload's entry, with the
    host's CPU beside the card: the step is host-bound."""
    from zraytrace_tpu_torch.tools.diff_bench import cpu_model

    return dict(metric=f"diff_step_eff_rays_per_s_{name}{suffix}", value=entry["eff_rays_per_s"],
                unit=FIT_UNIT, steps=entry["steps"], step_seconds=entry["step_seconds"],
                spread_pct=entry["spread_pct"], window_rate=entry["eff_rays_per_s_window"],
                step_seconds_list=entry["step_seconds_list"],
                first_step_seconds=entry["first_step_seconds"],
                rays_forward=entry["rays_forward"], loss_first=entry["loss_first"],
                launches_per_step=entry["launches_per_step"][0], config=entry["config"],
                **device_info, cpu_model=cpu_model(), checks=entry["checks"],
                correct=entry["correct"])


def run_cell(cell: str, device, seed: int = SEED, repeats: int = 5, steps: int = 10,
             size: int | None = None, spp: int | None = None, depth: int | None = None) -> dict:
    """One cell of ``CELLS`` as its JSON line; a cell that raises gives a
    line with ``"value": None``, ``"correct": False`` and ``"error"``, and
    a failed check one with ``"error"`` beside the measured value."""
    from zraytrace_tpu_torch.tools import diff_bench

    device = torch.device(device)
    info = card_info(device)
    if cell in FIT_CELLS:
        metric = f"diff_step_eff_rays_per_s_{cell}{_suffix(device)}"
    else:
        metric = RENDER_CELLS[int(cell[-1])].metric + _suffix(device)
    try:
        if cell in FIT_CELLS:
            fn, dims = diff_bench.WORKLOADS[cell]
            kw = dict(all_leaves=False) if cell == "sphere_albedo_fit" else {}
            entry = fn(size or dims["size"], spp or dims["spp"], depth or dims["depth"], steps,
                       seed, device, **kw)
            line = fit_line(cell, entry, info, _suffix(device))
        else:
            line = bench_render(int(cell[-1]), device, seed, repeats, size, spp, depth)
    except Exception as exc:  # the cell's line still prints, and the run fails
        traceback.print_exc(file=sys.stderr)
        return dict(metric=metric, value=None, unit=FIT_UNIT if cell in FIT_CELLS else UNIT,
                    **info, correct=False, error=f"{type(exc).__name__}: {exc}")
    if not line["correct"]:
        line["error"] = f"a check failed: {line['checks']}"
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m zraytrace_tpu_torch.bench")
    ap.add_argument("--scene", type=int, choices=sorted(RENDER_CELLS), default=1)
    ap.add_argument("--all", action="store_true", help="the four cells: " + ", ".join(CELLS))
    ap.add_argument("--size", type=int, default=None)
    ap.add_argument("--spp", type=int, default=None)
    ap.add_argument("--depth", type=int, default=None)
    ap.add_argument("--seed", type=int, default=SEED)
    ap.add_argument("--repeats", type=int, default=5, help="timed passes of a render cell")
    ap.add_argument("--steps", type=int, default=10, help="timed steps of a fit cell")
    ap.add_argument("--cpu", action="store_true", help="run on the host (cut sizes)")
    args = ap.parse_args(argv)
    try:
        device = pick_device(args.cpu)
    except RuntimeError as e:
        print(f"bench: {e}", file=sys.stderr)
        return 2
    cells = CELLS if args.all else (f"scene{args.scene}",)
    ok = True
    for cell in cells:
        line = run_cell(cell, device, args.seed, args.repeats, args.steps, args.size, args.spp,
                        args.depth)
        ok = ok and line["correct"]
        print(json.dumps(line), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
