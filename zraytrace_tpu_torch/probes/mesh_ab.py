"""How does the bounce kernel compare with another checkout's on the lanes
the main paths give it, in sphere mode and in mesh mode?

The port's own measurement (no TPU tool stands behind it). It builds
``csrc/bounce_kernel.cu`` of this checkout and, with ``--parent DIR``
(repeatable), of the checkout at ``DIR`` as it is, and launches each build
on the lanes ``render()`` gives the kernel (one launch, ``min(pixels,
2^20)`` lanes, each pixel's samples in one thread):

- ``scene1_4``: scene 1 (spheres only) at 1000x1000, 4 spp, depth 30
  (``chip_smoke.py`` phase 4), 5 launches a round;
- ``scene1_1000``: scene 1 at 1000x1000, 1000 spp, depth 30 (the render
  of phase 8);
- ``phase7``: scene 3 at 700x700, 4 spp, depth 20 (``chip_smoke.py``
  phase 7), 5 launches a round; ``phase7_1spp``, the same at 1 spp (each
  lane traces one path, so a sample loop and a segment loop schedule the
  same work), and ``phase7_bare``, phase 7's lanes on scene 3 without its
  mesh (sphere mode);
- ``teapot_500``: scene 3 at 700x700, 500 spp, depth 20 (the headline);
- ``man_100``, ``bunny_100``, ``circle_100``: scenes 0, 2 and 4 at
  700x700, 100 spp, depth 20;
- ``goat_256``: the goat-class scene (158,000 triangles) at 256x256, 64
  spp, depth 8.

A sphere scene gets null mesh pointers. For a mesh scene, a build whose
mesh mode walks the BVH (its source calls ``tri_bvh_winner``) is given the
node and row tables, an older one the chunk planes and boxes, in the same
argument slots. Each launch is timed with CUDA events (its outputs'
zeroing included, microseconds); the builds run in the order given (the
parents, then this checkout) and then in reverse (A B, B A), and each
time is the mean of the two rounds.
Each build's counters and slot sums are compared with this checkout's;
on a mesh scene, for each pixel whose sum differs (the first 8), the
plain wavefront retraces the pixel's samples on the card through the
flash kernel (the chunk scan's result) and lists every segment on which
the BVH walk's twin (``ops/mesh_bvh.py``) picks another winner. Last,
each build's counting instantiation gives its work counts, each read by
the build's own field list: per segment that reaches the mesh's root box
the walk's node, leaf and triangle tests, or the chunk scan's chunk slab
tests and 128 triangle tests per chunk visit; the bound they price
(``probes/bounds.py``, one yardstick for every build); and, from a build
that counts them, the loop's SIMT counts: ``lane_steps / (32 x
warp_iters)``, the share of issued lanes that did work, and the material
branches per warp iteration. ``lane_steps`` must equal rays plus
recursion-depth hits.

    python -m zraytrace_tpu_torch.probes.mesh_ab [--parent DIR ...] [shape ...]

Needs a CUDA device. Prints ``[ptxas]``, ``[ab]``, ``[work]`` and
``[simt]`` lines and one JSON line; exits 1 where the ``lane_steps``
identity fails.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

from zraytrace_tpu_torch.ops import bounce_kernel as bk
from zraytrace_tpu_torch.ops import flash_intersect as fi
from zraytrace_tpu_torch.ops.build import load
from zraytrace_tpu_torch.probes.bounds import bounce_flops, bound, nbytes
from zraytrace_tpu_torch.probes.common import THIS, ab_rounds, build_checkouts, card_line

SEED = 42
# shape -> (scene index, "goat" for the goat-class scene or "bare3" for
# scene 3 without its mesh; width, height, spp, depth)
SHAPES = {"scene1_4": (1, 1000, 1000, 4, 30), "scene1_1000": (1, 1000, 1000, 1000, 30),
          "phase7": (3, 700, 700, 4, 20), "phase7_1spp": (3, 700, 700, 1, 20),
          "phase7_bare": ("bare3", 700, 700, 4, 20), "teapot_500": (3, 700, 700, 500, 20),
          "man_100": (0, 700, 700, 100, 20), "bunny_100": (2, 700, 700, 100, 20),
          "circle_100": (4, 700, 700, 100, 20), "goat_256": ("goat", 256, 256, 64, 8)}
REPS = {"scene1_4": 5, "phase7": 5, "phase7_1spp": 5, "phase7_bare": 5}  # per round (1 elsewhere)
# the work counts of a build without the SIMT counts: a BVH walk's, and a
# chunk scan's (its tri_winner.cuh W_* and W_DISC...)
WALK_WORK_FIELDS = bk.WORK_FIELDS[:bk.WORK_FIELDS.index("tri_hits") + 1]
CHUNK_WORK_FIELDS = fi.WORK_FIELDS + ("disc", "root", "tri_hits")
# SIMT efficiency of the host model (probes/simt_model.py, seed 42) at
# scene1_4: a sample loop around a depth loop, and one segment loop
MODEL_SIMT = {"scene1_4": (0.4835, 0.6671)}


class Build:
    """One build of the bounce kernel, launched through its C entry."""

    def __init__(self, name: str, csrc: Path):
        self.name = name
        source = (csrc / "bounce_kernel.cu").read_text()
        self.walk = "tri_bvh_winner" in source
        self.lib = bk.bind(load("bounce_kernel", csrc))
        self.fields = (bk.WORK_FIELDS if "W_LANE_STEPS" in source
                       else WALK_WORK_FIELDS if self.walk else CHUNK_WORK_FIELDS)

    def launcher(self, scene, camera, tf, w, h, spp, depth):
        """``render()``'s launch on outputs of its own: a function of
        ``work=None`` that zeroes the counters, launches and returns
        ``(slot_sums, counters)``. ``tf`` is None for a sphere scene."""
        dev = scene.sph_center.device
        n_pix = w * h
        n = min(n_pix, 1 << 20)
        slots = -(-n_pix // n)
        base = torch.arange(n, dtype=torch.int32, device=dev)
        spheres, mats, cam = bk.scene_tables(scene, camera)
        atlas = scene.atlas.contiguous()
        if tf is None:
            mesh = (None,) * 4 + (0,)
        elif self.walk:
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
                *[None if x is None else x.data_ptr() for x in mesh[:4]], mesh[4],
                None if work is None else work.data_ptr(), base.data_ptr(), n, w, h, 0, spp,
                depth, SEED, n, n_pix, slots, sums.data_ptr(), counters.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
            if err:
                raise RuntimeError(f"{self.name}: bounce launch failed ({err})")
            return sums, counters
        return launch


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
    "bound_by", "simt"}`` (``per_root_segment`` empty on a sphere scene,
    ``simt`` None from a build without the SIMT counts)."""
    from zraytrace_tpu_torch.render import flash_pack_cached
    from zraytrace_tpu_torch.scenes import build_scene, goat_class

    all_builds = [Build(name, csrc)
                  for name, csrc in build_checkouts(("bounce_kernel",), parents).items()]
    rows, scenes = [], {}
    for shape in shapes or SHAPES:
        index, w, h, spp, depth = SHAPES[shape]
        if index not in scenes:
            if index == "goat":
                b = goat_class(dev)
            elif index == "bare3":
                b = build_scene(3, dev)
                b = b._replace(scene=b.scene._replace(
                    **{k: getattr(b.scene, k)[:0] for k in ("tri_a", "tri_b", "tri_c", "tri_mat")}))
            else:
                b = build_scene(index, dev)
            tf = flash_pack_cached(b.scene) if b.scene.n_triangles else None
            scenes[index] = (b.scene, b.camera, tf)
        scene, camera, tf = scenes[index]
        launch = {b.name: b.launcher(scene, camera, tf, w, h, spp, depth) for b in all_builds}
        outs = {b.name: launch[b.name]() for b in all_builds}  # warm-up, and the results
        times = ab_rounds({b.name: lambda f=launch[b.name]: _timed(f, dev, REPS.get(shape, 1))
                           for b in all_builds})
        ref_sums, ref_counters = (x.clone() for x in outs[THIS])
        for b in all_builds:
            sums, counters = (x.clone() for x in outs[b.name])
            work = torch.zeros((len(b.fields),), dtype=torch.int64, device=dev)
            launch[b.name](work=work)
            work = dict(zip(b.fields, work.tolist()))
            c = counters.tolist()
            if tf is None:
                tables, per = (), {}
            else:
                tables = (tf.nodes, tf.rows, tf.attrs) if b.walk else (tf.planes, tf.bounds,
                                                                       tf.attrs)
                per = {k: round(work[k] / max(work["root"], 1), 4)
                       for k in b.fields[:b.fields.index("disc")]}
            spheres, mats, _ = bk.scene_tables(scene, camera)
            b_ms, b_by = bound(bounce_flops(c, scene.n_spheres, work, mesh=tf is not None),
                               nbytes(*tables, spheres, mats, scene.atlas, sums))
            ms = sum(times[b.name]) / 2
            equal = torch.equal(counters, ref_counters) and torch.equal(sums, ref_sums)
            slot, lane = torch.nonzero((sums != ref_sums).any(-1)).t().tolist()
            pixels = [k * sums.shape[1] + i for k, i in zip(slot, lane)]
            segments = (differing_segments(scene, camera, tf, pixels[:8], w, h, spp, depth)
                        if pixels and tf is not None else [])
            rows.append(dict(shape=shape, build=b.name, walk=b.walk, ms=ms, rounds=times[b.name],
                             counters=c, equal=equal, pixels_differing=pixels,
                             segments_differing=segments, work=work, per_root_segment=per,
                             bound_ms=b_ms, bound_by=b_by,
                             simt=bk.simt(work, c) if "lane_steps" in work else None))
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
        kind = ("sphere mode" if not r["per_root_segment"] else
                "BVH walk" if r["walk"] else "chunk scan")
        reach = (f"{r['work']['root']} segments reach the root box; per such segment "
                 f"{r['per_root_segment']}; " if r["per_root_segment"] else "no mesh; ")
        print(f"[work] {r['shape']} {r['build']} ({kind}): {reach}bound {r['bound_ms']:.4f} "
              f"ms ({r['bound_by']}), {r['ms'] / r['bound_ms']:.1f}x, on {card}", flush=True)
    broken = []
    for r in rows:
        if r["simt"] is None:
            continue
        m = r["simt"]
        model = MODEL_SIMT.get(r["shape"])
        against = (f" (host model, probes/simt_model.py: sample loop around a depth loop "
                   f"{model[0]:.1%}, one segment loop {model[1]:.1%})" if model else "")
        print(f"[simt] {r['shape']} {r['build']}: lane_steps {m['lane_steps']} "
              f"{'=' if m['identity'] else '!='} rays + recursion-depth hits; warp_iters "
              f"{m['warp_iters']}; lane_steps / (32 x warp_iters) {m['efficiency']:.4f}"
              f"{against}; {m['branches_per_iter']:.3f} material branches per warp iteration"
              + (f"; walk nodes / (32 x warp_nodes) {m['walk_efficiency']:.4f}"
                 if m["walk_efficiency"] is not None else ""), flush=True)
        if not m["identity"]:
            broken.append(f"{r['shape']} {r['build']}")
    print(json.dumps({"mesh_ab": rows, "card": card}))
    if broken:
        print(f"mesh_ab: lane_steps != rays + recursion-depth hits in {broken}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
