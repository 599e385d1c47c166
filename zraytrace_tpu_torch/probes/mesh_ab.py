"""How does the bounce kernel's mesh mode compare with another checkout's
on the lanes the main paths give it?

The port's own measurement (no TPU tool stands behind it). It builds
``csrc/bounce_kernel.cu`` of this checkout and, with ``--parent DIR``
(repeatable), of the checkout at ``DIR`` as it is, and launches each build
on the lanes ``render()`` gives the kernel (one launch, ``min(pixels,
2^20)`` lanes, each pixel's samples in one thread):

- ``phase7``: scene 3 at 700x700, 4 spp, depth 20 (``chip_smoke.py``
  phase 7), 5 launches a round;
- ``teapot_500``: scene 3 at 700x700, 500 spp, depth 20 (the headline);
- ``man_100``, ``bunny_100``, ``circle_100``: scenes 0, 2 and 4 at
  700x700, 100 spp, depth 20;
- ``goat_256``: the goat-class scene (158,000 triangles) at 256x256, 64
  spp, depth 8.

A build whose mesh mode walks the BVH (its source calls
``tri_bvh_winner``) is given the node and row tables, an older one the
chunk planes and boxes, in the same argument slots. Each launch is timed
with CUDA events (its outputs' zeroing included, microseconds); the builds
run in the order given and then in reverse (A B, B A), and each time is the
mean of the two rounds. Each build's counters and slot sums are compared
with this checkout's; for each pixel whose sum differs (the first 8), the
plain wavefront retraces the pixel's samples on the card through the
flash kernel (the chunk scan's result) and lists every segment on which
the BVH walk's twin (``ops/mesh_bvh.py``) picks another winner. Last,
each build's counting instantiation gives its work counts per segment
that reaches the mesh's root box, and the bound
they price (``probes/bounds.py``): the walk's node, leaf and triangle
tests, or the chunk scan's chunk slab tests and 128 triangle tests per
chunk visit.

    python -m zraytrace_tpu_torch.probes.mesh_ab [--parent DIR ...] [shape ...]

Needs a CUDA device. Prints ``[ptxas]``, ``[ab]`` and ``[work]`` lines and
one JSON line.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import sys
from pathlib import Path

import torch

from zraytrace_tpu_torch.ops import bounce_kernel as bk
from zraytrace_tpu_torch.ops import flash_intersect as fi
from zraytrace_tpu_torch.ops.build import CSRC, build, load
from zraytrace_tpu_torch.probes.bounds import bounce_flops, bound, nbytes
from zraytrace_tpu_torch.probes.common import card_line

THIS = "this"  # the name of this checkout's build
SEED = 42
# shape -> (scene index, or "goat" for the goat-class scene; width, height,
# spp, depth)
SHAPES = {"phase7": (3, 700, 700, 4, 20), "teapot_500": (3, 700, 700, 500, 20),
          "man_100": (0, 700, 700, 100, 20), "bunny_100": (2, 700, 700, 100, 20),
          "circle_100": (4, 700, 700, 100, 20), "goat_256": ("goat", 256, 256, 64, 8)}
REPS = {"phase7": 5}  # launches per timed round (1 elsewhere)
# a chunk-scan build's work counts (its tri_winner.cuh W_* and W_DISC...)
CHUNK_WORK_FIELDS = fi.WORK_FIELDS + ("disc", "root", "tri_hits")


class Build:
    """One build of the bounce kernel, launched through its C entry."""

    def __init__(self, name: str, csrc: Path):
        self.name = name
        self.walk = "tri_bvh_winner" in (csrc / "bounce_kernel.cu").read_text()
        self.lib = bk.bind(load("bounce_kernel", csrc))
        self.fields = bk.WORK_FIELDS if self.walk else CHUNK_WORK_FIELDS

    def launcher(self, scene, camera, tf, w, h, spp, depth):
        """``render()``'s launch on outputs of its own: a function of
        ``work=None`` that zeroes the counters, launches and returns
        ``(slot_sums, counters)``."""
        dev = tf.planes.device
        n_pix = w * h
        n = min(n_pix, 1 << 20)
        slots = -(-n_pix // n)
        base = torch.arange(n, dtype=torch.int32, device=dev)
        spheres, mats, cam = bk.scene_tables(scene, camera)
        atlas = scene.atlas.contiguous()
        if self.walk:
            mesh = (tf.nodes, tf.rows, tf.attrs, tf.root, tf.nodes.shape[0])
        else:
            mesh = (tf.planes, tf.bounds, tf.attrs, tf.root, tf.n_chunks)
        sums = torch.zeros((slots, n, 3), dtype=torch.float32, device=dev)
        counters = torch.zeros((6,), dtype=torch.int64, device=dev)

        def launch(work=None):
            counters.zero_()
            err = self.lib.zr_bounce_launch(
                spheres.data_ptr(), spheres.shape[0], mats.data_ptr(), mats.shape[0],
                cam.data_ptr(), atlas.data_ptr(), atlas.shape[2],
                *[x.data_ptr() for x in mesh[:4]], mesh[4],
                None if work is None else work.data_ptr(), base.data_ptr(), n, w, h, 0, spp,
                depth, SEED, n, n_pix, slots, sums.data_ptr(), counters.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
            if err:
                raise RuntimeError(f"{self.name}: bounce launch failed ({err})")
            return sums, counters
        return launch


def builds(parents=()) -> list[Build]:
    """This checkout's build, then each checkout in ``parents``, named by
    its directory; compiled in parallel, with nvcc's register report."""
    jobs = {THIS: CSRC}
    for p in parents:
        jobs[Path(p).name] = Path(p).resolve() / "zraytrace_tpu_torch" / "csrc"
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        futures = {name: pool.submit(build, "bounce_kernel", csrc) for name, csrc in jobs.items()}
        for name, f in futures.items():
            entry = None
            for line in f.result()["log"].splitlines():
                if "entry function" in line:
                    entry = line.split("'")[1] if "'" in line else line.strip()
                elif "registers" in line or "spill" in line:
                    print(f"[ptxas] {name} {entry}: {line.strip()}", flush=True)
    return [Build(name, csrc) for name, csrc in jobs.items()]


def _timed(fn, dev, reps: int) -> float:
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize(dev)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize(dev)
    return start.elapsed_time(end) / reps


def differing_segments(scene, camera, tf, pixels, w, h, spp, depth) -> list[dict]:
    """The segments of these pixels' paths on which the BVH walk's winner
    (its plain twin, the kernel's arithmetic) differs from the chunk
    scan's: the plain wavefront traces the pixels through the flash
    kernel (the chunk scan's result, bit for bit), and every segment it
    hands the winner is held to the walk."""
    from zraytrace_tpu_torch.kernel_inputs import recorded_calls
    from zraytrace_tpu_torch.ops.mesh_bvh import bvh_winner_plain
    from zraytrace_tpu_torch.render import wavefront_trace

    calls = {}
    with recorded_calls(calls):
        for p in pixels:
            base = torch.tensor([p], dtype=torch.int32, device=tf.planes.device)
            wavefront_trace(scene, camera, base, SEED, w, h, spp, depth, 0, 1, w * h, 1,
                            tri_flash=tf)
    found = []
    for c in calls.get("flash_intersect", []):
        want = fi.flash_intersect_plain(c.planes, c.o, c.d, c.t_min, c.x)
        got, _ = bvh_winner_plain(c.planes, c.o, c.d, c.t_min, c.x)
        bad = (got[0] != want[0]) | (got[1] != want[1]) | (got[2] != want[2])
        for i in torch.nonzero(bad)[:, 0].tolist():
            found.append(dict(o=c.o[i].tolist(), d=c.d[i].tolist(), t_init=float(c.x[i]),
                              chunk_scan=(float(want[0][i]), int(want[1][i]), bool(want[2][i])),
                              walk=(float(got[0][i]), int(got[1][i]), bool(got[2][i]))))
    return found


def measure(dev, parents=(), shapes=None) -> list[dict]:
    """One row per shape and build: ``{"shape", "build", "walk", "ms",
    "rounds", "counters", "equal", "pixels_differing",
    "segments_differing", "work", "per_root_segment", "bound_ms",
    "bound_by"}``."""
    from zraytrace_tpu_torch.render import flash_pack_cached
    from zraytrace_tpu_torch.scenes import build_scene, goat_class

    all_builds = builds(parents)
    rows, scenes = [], {}
    for shape in shapes or SHAPES:
        index, w, h, spp, depth = SHAPES[shape]
        if index not in scenes:
            b = goat_class(dev) if index == "goat" else build_scene(index, dev)
            scenes[index] = (b.scene, b.camera, flash_pack_cached(b.scene))
        scene, camera, tf = scenes[index]
        launch = {b.name: b.launcher(scene, camera, tf, w, h, spp, depth) for b in all_builds}
        outs = {b.name: launch[b.name]() for b in all_builds}  # warm-up, and the results
        times = {b.name: [] for b in all_builds}
        for order in (all_builds, all_builds[::-1]):
            for b in order:
                times[b.name].append(_timed(launch[b.name], dev, REPS.get(shape, 1)))
        ref_sums, ref_counters = (x.clone() for x in outs[THIS])
        for b in all_builds:
            sums, counters = (x.clone() for x in outs[b.name])
            work = torch.zeros((len(b.fields),), dtype=torch.int64, device=dev)
            launch[b.name](work=work)
            work = dict(zip(b.fields, work.tolist()))
            c = counters.tolist()
            tables = (tf.nodes, tf.rows) if b.walk else (tf.planes, tf.bounds)
            b_ms, b_by = bound(bounce_flops(c, scene.n_spheres, work, mesh=True),
                               nbytes(*tables, tf.attrs, scene.atlas, sums))
            per = {k: round(work[k] / max(work["root"], 1), 4) for k in b.fields[:-3]}
            ms = sum(times[b.name]) / 2
            equal = torch.equal(counters, ref_counters) and torch.equal(sums, ref_sums)
            slot, lane = torch.nonzero((sums != ref_sums).any(-1)).t().tolist()
            pixels = [k * sums.shape[1] + i for k, i in zip(slot, lane)]
            segments = (differing_segments(scene, camera, tf, pixels[:8], w, h, spp, depth)
                        if pixels else [])
            rows.append(dict(shape=shape, build=b.name, walk=b.walk, ms=ms, rounds=times[b.name],
                             counters=c, equal=equal, pixels_differing=pixels,
                             segments_differing=segments, work=work, per_root_segment=per,
                             bound_ms=b_ms, bound_by=b_by))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, action="append", default=[],
                    help="root of another checkout to time beside (repeatable)")
    ap.add_argument("shapes", nargs="*", help=f"of {list(SHAPES)} (default: all)")
    args = ap.parse_args(argv)
    if set(args.shapes) - set(SHAPES):
        ap.error(f"unknown shapes {sorted(set(args.shapes) - set(SHAPES))}")
    if not torch.cuda.is_available():
        print("mesh_ab: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"gpu: {card}", flush=True)
    rows = measure(dev, args.parent, args.shapes)
    for r in rows:
        same = ("equal to this build's" if r["equal"] else
                f"counters or sums differ from this build's ({len(r['pixels_differing'])} "
                f"pixels: {r['pixels_differing'][:8]})")
        print(f"[ab] {r['shape']} {r['build']}: {r['ms']:.4f} ms per launch (rounds "
              f"{', '.join(f'{x:.4f}' for x in r['rounds'])}); counters {r['counters']}, "
              f"{same}, on {card}", flush=True)
    for r in rows:
        for seg in r["segments_differing"]:
            print(f"[differs] {r['shape']} {r['build']}: segment o {seg['o']} d {seg['d']} "
                  f"t_init {seg['t_init']}: chunk scan (t, id, hit) {seg['chunk_scan']}, BVH walk "
                  f"{seg['walk']}", flush=True)
    for r in rows:
        kind = "BVH walk" if r["walk"] else "chunk scan"
        print(f"[work] {r['shape']} {r['build']} ({kind}): {r['work']['root']} segments reach "
              f"the root box; per such segment {r['per_root_segment']}; bound {r['bound_ms']:.4f} "
              f"ms ({r['bound_by']}), {r['ms'] / r['bound_ms']:.1f}x, on {card}", flush=True)
    print(json.dumps({"mesh_ab": rows, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
