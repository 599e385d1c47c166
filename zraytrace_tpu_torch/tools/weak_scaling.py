"""Weak-scaling harness: ``parallel.mesh.render_sharded`` at constant
work per rank while the rank count grows.

Counterpart of ``tools/weak_scaling.py``. For N ranks (1, 2, 4, and 8
where the host has 8 cores) it renders, over each mesh axis in turn:

- ``data`` (pixel slices, no collective inside the trace): an image of
  ``base * N`` rows, so the pixels per rank stay constant;
- ``sample`` (sample slices, the partial sums all-reduced): ``spp * N``
  samples per pixel, so the samples per rank stay constant;

and reports per row the wall time of the second render (the first pays
first launches and first collectives), the rays, the rates and the
weak-scaling efficiency ``t(1) / t(N)``, with each row's event counters
(which equal ``render()``'s at the same parameters).

The ranks are processes of this host (``parallel.multihost.run_ranks``).
By default they share the card: one rank forms an NCCL group, several a
gloo group, since NCCL takes one rank per card. With ``--cpu`` they are
gloo ranks rendering on the host. Either way the ranks share one device
and the host's cores, so the efficiency measures that sharing, not
scaling across cards; the report's ``caveat`` says so.

    python -m zraytrace_tpu_torch.tools.weak_scaling [--cpu]
        [--out WEAK_SCALING_TORCH.json]

writes the port's report (never the reference's ``WEAK_SCALING.json``)
and prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from zraytrace_tpu_torch.tools.common import card_info, pick_device

__all__ = ["AXES", "rank_counts", "weak_scaling", "main"]

AXES = ("data", "sample")
DEPTH = 8
# the store's launch counters a rank reports, in this order (``profiling``)
LAUNCH_COUNTERS = ("launch.bounce", "launch.bounce_mesh", "launch.flash", "launch.margins")
CAVEAT = ("the ranks are processes of one host sharing one device ({device}) and its "
          "{cores} cores (one rank: {one}; several: gloo), so the efficiency measures that "
          "sharing, not scaling across cards")


def rank_counts(cores: int | None = None) -> list[int]:
    """1, 2, 4, and 8 where the host has at least 8 cores."""
    cores = os.cpu_count() if cores is None else cores
    return [n for n in (1, 2, 4, 8) if n < 8 or (cores or 1) >= 8]


def _params(axis: str, n: int, width: int, base: int, spp: int, seed: int):
    from zraytrace_tpu_torch import RenderParams

    if axis == "data":
        return RenderParams(width=width, height=base * n, samples_per_pixel=spp,
                            max_depth=DEPTH, seed=seed)
    return RenderParams(width=width, height=base, samples_per_pixel=spp * n, max_depth=DEPTH,
                        seed=seed)


def _rank(rank: int, world: int, scene_index: int, width: int, base: int, spp: int, seed: int,
          device: str) -> dict:
    """One rank: both axes' renders at ``world`` ranks, each rendered
    twice and the second timed (synchronised, host clock), with the
    kernel launches of both (bounce, mesh-mode bounce, flash, margins)."""
    from zraytrace_tpu_torch.parallel.mesh import make_mesh, render_sharded
    from zraytrace_tpu_torch.profiling import counter
    from zraytrace_tpu_torch.scenes import build_scene
    from zraytrace_tpu_torch.tools.common import wall

    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    built = build_scene(scene_index, dev)
    out = {}
    for axis in AXES:
        mesh = make_mesh(world, 1, device=dev) if axis == "data" else make_mesh(1, world,
                                                                               device=dev)
        params = _params(axis, world, width, base, spp, seed)
        before = [counter(k) for k in LAUNCH_COUNTERS]
        render_sharded(built.scene, built.camera, params, mesh)
        (_, st), seconds = wall(lambda: render_sharded(built.scene, built.camera, params, mesh),
                                dev)
        after = [counter(k) for k in LAUNCH_COUNTERS]
        out[axis] = dict(wall=seconds, counters=[
            st.rays, st.reflections, st.background_hits, st.recursion_depth_hits, st.samples,
            st.wavefront_iterations], launches=[a - b for a, b in zip(after, before)])
    return out


def weak_scaling(device, counts=None, scene_index: int = 1, width: int = 128, base: int = 96,
                 spp: int = 16, seed: int = 42, timeout: float = 600.0) -> dict:
    """The report: ``host_cores``, ``n_virtual_devices`` (the most ranks),
    ``caveat``, ``axes`` (per axis one row per rank count), the device
    and its power limit. A row's ``wall_seconds`` is the slowest rank's."""
    from zraytrace_tpu_torch.parallel.multihost import run_ranks

    device = torch.device(device)
    counts = rank_counts() if counts is None else list(counts)
    info = card_info(device)
    rows = {axis: [] for axis in AXES}
    for n in counts:
        backend = "nccl" if device.type == "cuda" and n == 1 else "gloo"
        per_rank = run_ranks(_rank, n, scene_index, width, base, spp, seed, str(device),
                             backend=backend, device=device if device.type == "cuda" else None,
                             timeout=timeout)
        for axis in AXES:
            wall_s = max(r[axis]["wall"] for r in per_rank)
            counters = per_rank[0][axis]["counters"]
            rays = counters[0]
            rows[axis].append(dict(
                n_devices=n, backend=backend, wall_seconds=wall_s, rays=rays,
                rays_per_sec_total=rays / wall_s, rays_per_sec_per_device=rays / wall_s / n,
                counters=counters, launches_per_rank=[r[axis]["launches"] for r in per_rank],
                params=dict(width=width, height=base * n if axis == "data" else base,
                            spp=spp * n if axis == "sample" else spp, depth=DEPTH)))
            print(f"{axis}: N={n} ({backend}) wall={wall_s:.4f}s rays={rays} "
                  f"({rays / wall_s / n / 1e6:.3f}M rays/s per rank) on {info['device']}",
                  flush=True)
    for axis_rows in rows.values():
        t1 = axis_rows[0]["wall_seconds"]
        for r in axis_rows:
            r["weak_scaling_efficiency"] = t1 / r["wall_seconds"]
    return {"host_cores": os.cpu_count(), "n_virtual_devices": max(counts),
            "caveat": CAVEAT.format(device=info["device"], cores=os.cpu_count(),
                                    one="nccl" if device.type == "cuda" else "gloo"),
            "axes": rows, "scene": scene_index, **info}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m zraytrace_tpu_torch.tools.weak_scaling")
    ap.add_argument("--out", default="WEAK_SCALING_TORCH.json")
    ap.add_argument("--scene", type=int, default=1)
    ap.add_argument("--base", type=int, default=96, help="pixel rows per rank (data axis)")
    ap.add_argument("--width", type=int, default=128)
    ap.add_argument("--spp", type=int, default=16, help="samples per pixel per rank")
    ap.add_argument("--counts", type=int, nargs="*", default=None,
                    help="rank counts (default 1 2 4, and 8 with 8 cores)")
    ap.add_argument("--cpu", action="store_true", help="gloo ranks rendering on the host")
    args = ap.parse_args(argv)
    if os.path.basename(args.out) == "WEAK_SCALING.json":
        raise SystemExit("WEAK_SCALING.json is the JAX package's report; write the port's "
                         "elsewhere (default WEAK_SCALING_TORCH.json)")
    device = pick_device(args.cpu)
    t0 = time.perf_counter()
    report = weak_scaling(device, args.counts, args.scene, args.width, args.base, args.spp)
    report["wall_seconds"] = time.perf_counter() - t0
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps({"metric": "weak_scaling_efficiency_max_devices",
                      **{a: report["axes"][a][-1]["weak_scaling_efficiency"] for a in AXES},
                      "device": report["device"], "power_limit": report["power_limit"],
                      "caveat": "ranks sharing one device, not scaling across cards"}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
