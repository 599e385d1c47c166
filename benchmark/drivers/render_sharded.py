"""Traffic of ``kind`` ``render_sharded``: ``drivers/render.py``'s closed
loop of images, each split over one rank a card by the program's
``parallel.mesh.render_sharded``.

The ranks are processes of their own, one a card, started by the
program's ``multihost.run_ranks(..., backend="nccl", device="cuda")``
(rank r on ``cuda:<r>``), on the configuration's ``cluster`` ``mesh``
(``threeBalls_node4``: 4x1, every rank on ``data``, one sample shard,
``make_mesh()``'s default). On the host (the benchmark's tests) they are
gloo ranks on the CPU.

- Set-up: each rank forms the mesh, builds the scene on its card and
  renders one warm-up image; a barrier ends set-up. ``setup_end`` is
  rank 0's ``time.perf_counter()`` after it: on Linux ``CLOCK_MONOTONIC``,
  one clock for every process of the host, so it compares with
  ``run.py``'s ``T_START``.
- Window: rank 0 times each image from the ``render_sharded`` call until
  the image is on its host; after each image it decides whether the
  window goes on and broadcasts the decision, so every rank renders the
  same images, each with its own seed (``drivers.render.image_seed``).
  The window's seconds end when every rank's work for the last image is
  done (a barrier).
- Each rank returns its card's record (``benchmark.cards.record``, taken
  after its last image: the result's ``devices``), its ``mesh.render``
  records as numbers (``ranks``, read by ``metrics/_ranks.py``), its
  ``scene.build`` records, and the JAX modules it loaded, which fail the
  run (``run.py``'s check sees only its own process). The longest scene
  build, which set-up waited for, is kept in this process's span store
  (``profiling.keep``), where ``setup_scene_s`` reads it. Rank 0 also
  returns the window's images: seconds, counters and values at the
  checked pixels.
- With ``--trace 1`` every rank profiles the same images
  (``devtrace.profiled``). Each rank's profile is the result's
  ``rank_profiles``; the result's ``profile`` is their sum over the cards
  (``merged``), and its ``profiled_images`` rank 0's counters of those
  images, which are the whole image's.
- Check: after the ranks have exited, in this process on
  ``cell.device``, exactly ``drivers/render.py``'s.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from benchmark import devtrace
from benchmark.drivers import sync
from benchmark.drivers.render import (EVENTS, PROFILED, WARM_UP, WINDOW, event_paths,
                                      image_seed, numbers, program_scene, reference_events,
                                      reference_rows, window_metrics)
from benchmark.reference import scene as ref_scene

# seconds a rank may take, beyond the window, for its imports, the kernel's
# build, the scene and the warm-up image; again for a traced pass
SETUP_S = 300.0


def _agree(value: int, dev) -> int:
    """Rank 0's ``value`` on every rank (a broadcast, waited for)."""
    import torch.distributed as dist

    t = torch.tensor([value], dtype=torch.int64, device=dev)
    dist.broadcast(t, 0)
    return int(t.item())


def _barrier(dev) -> None:
    """Return once every rank has come here (an all-reduce, waited for)."""
    import torch.distributed as dist

    t = torch.ones(1, device=dev)
    dist.all_reduce(t)
    t.item()


def _records(since: float) -> tuple:
    """This rank's ``mesh.render`` records as numbers: when each opened,
    whether a profiler was on, its forward spans' seconds by name and its
    counters."""
    from zraytrace_tpu_torch import profiling

    return since, [dict(started=r.started, profiled=r.profiled,
                        spans={name: st.seconds for (name, rec), st in r.spans.items() if not rec},
                        counters=dict(r.counters)) for r in profiling.records("mesh.render")]


def _rank(rank: int, world: int, job: dict) -> dict:
    from benchmark import cards
    from benchmark.run import FORBIDDEN
    from zraytrace_tpu_torch import profiling
    from zraytrace_tpu_torch.config import RenderParams
    from zraytrace_tpu_torch.parallel.mesh import make_mesh, render_sharded

    # torchrun's default where it starts more than one process on a host:
    # OMP_NUM_THREADS=1, one intra-op thread a rank
    torch.set_num_threads(1)
    w, h, spp, depth = job["size"]
    mesh = make_mesh(n_sample=job["n_sample"], device=job["device"])
    dev = mesh.device
    built = program_scene(job["desc"], dev)
    pix_t = torch.as_tensor(job["pixels"])

    def one(seed):
        t0 = time.perf_counter()
        img, st = render_sharded(built.scene, built.camera,
                                 RenderParams(width=w, height=h, samples_per_pixel=spp,
                                              max_depth=depth, seed=seed), mesh)
        return img, st, time.perf_counter() - t0

    one(image_seed(job["seed"], WARM_UP, 0))  # every shape of the window, built and warmed
    sync(dev)
    _barrier(dev)
    setup_end = time.perf_counter()

    images = []
    t0 = time.perf_counter()
    while True:
        seed = image_seed(job["seed"], WINDOW, len(images))
        img, st, sec = one(seed)
        images.append(dict(seed=seed, seconds=sec, values=img.reshape(-1, 3)[pix_t].numpy(),
                           rays=st.rays, reflections=st.reflections,
                           background_hits=st.background_hits,
                           recursion_depth_hits=st.recursion_depth_hits, samples=st.samples,
                           ok=(st.samples == w * h * spp and st.rays == st.reflections
                               + st.samples - st.recursion_depth_hits)))
        if not _agree(time.perf_counter() - t0 < job["seconds"], dev):
            break
    sync(dev)
    _barrier(dev)
    window_s = time.perf_counter() - t0

    profile, profiled = None, []
    if job["trace"]:
        it = iter([image_seed(job["seed"], PROFILED, k) for k in range(job["profile_images"])])
        profiled, profile = devtrace.profiled(lambda: one(next(it)), job["profile_images"], dev)
    out = dict(records=_records(setup_end), profile=profile,
               builds=profiling.records("scene.build"),
               forbidden=sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN)))
    if dev.type == "cuda":
        out["device"] = cards.record(dev, profile)
    if rank == 0:
        out.update(setup_end=setup_end, window_s=window_s, images=images,
                   profiled_images=[dict(rays=st.rays, reflections=st.reflections,
                                         background_hits=st.background_hits,
                                         recursion_depth_hits=st.recursion_depth_hits,
                                         samples=st.samples) for _, st, _ in profiled])
    return out


def merged(profiles: list) -> dict:
    """The ranks' traced passes (``devtrace.profiled``) as one over their
    cards: busy and window seconds summed, so the idle share is over all
    the card time, as ``cards.block`` sums them; busy seconds by card;
    device operations, and kernels' seconds and counts by name, summed;
    the breakdown's rows summed by name over the ranks' (each rank's
    longest), the longest kept."""
    def summed(rows):
        acc: dict = {}
        for k, v in rows:
            acc[k] = acc.get(k, 0) + v
        return acc

    def top(key):
        rows = summed(row for p in profiles for row in p["breakdown"][key])
        return [[k, v] for k, v in sorted(rows.items(), key=lambda kv: -kv[1])[:devtrace.TOP]]

    return dict(busy_s=sum(p["busy_s"] for p in profiles),
                busy_by_card={i: s for p in profiles for i, s in p["busy_by_card"].items()},
                window_s=sum(p["window_s"] for p in profiles),
                device_ops=sum(p["device_ops"] for p in profiles),
                kernels=summed(kv for p in profiles for kv in p["kernels"].items()),
                kernel_counts=summed(kv for p in profiles for kv in p["kernel_counts"].items()),
                breakdown=dict(device_ops=top("device_ops"), idle_gaps=top("idle_gaps")))


def _keep_build(outs: list) -> None:
    """The ranks' longest ``scene.build`` record, kept in this process's
    span store."""
    from zraytrace_tpu_torch import profiling

    builds = [r for o in outs for r in o["builds"]]
    if builds:
        profiling.keep(max(builds, key=lambda r: r.seconds))


def run(cell) -> dict:
    from zraytrace_tpu_torch.parallel.multihost import run_ranks

    rc = cell.config["render"]
    desc = cell.config["scenes"][rc["scene"]]
    w, h, spp, depth = rc["width"], rc["height"], rc["spp"], rc["depth"]
    drawn = cell.traffic["check"]
    pixels = np.sort(np.random.default_rng([cell.seed % 2**64, 1]).choice(
        w * h, size=min(drawn["pixels"], w * h), replace=False))
    layout = cell.config["cluster"]["mesh"]
    cuda = torch.device(cell.device).type == "cuda"
    job = dict(desc=desc, size=(w, h, spp, depth), seed=cell.seed, seconds=cell.seconds,
               trace=cell.trace, profile_images=cell.traffic["profile_images"], pixels=pixels,
               device="cuda" if cuda else "cpu", n_sample=layout["sample"])
    world = layout["data"] * layout["sample"]
    if cuda and len(cell.devices) != world:
        raise RuntimeError(f"the configuration's {world} ranks, one a card, "
                           f"were handed {len(cell.devices)} cards")
    outs = run_ranks(_rank, world, job,
                     backend="nccl" if cuda else "gloo", device=job["device"],
                     timeout=SETUP_S * (2 if cell.trace else 1) + cell.seconds)
    found = sorted({m for o in outs for m in o["forbidden"]})
    if found:
        raise RuntimeError(f"a rank loaded {found}: the port must run without JAX")
    zero = outs[0]
    images, window_s = zero["images"], zero["window_s"]
    res = dict(setup_end=zero["setup_end"], window_s=window_s, images=images,
               attempted=len(images), failed=sum(not im["ok"] for im in images), width=w,
               height=h, metrics=window_metrics(images, window_s),
               ranks=[o["records"] for o in outs])
    if cuda:
        res["devices"] = [o["device"] for o in outs]
    if cell.trace:
        res.update(profile=merged([o["profile"] for o in outs]),
                   rank_profiles=[o["profile"] for o in outs],
                   profiled_images=zero["profiled_images"])
    _keep_build(outs)
    picked = np.random.default_rng([cell.seed % 2**64, 2]).choice(
        len(images), size=min(drawn["images"], len(images)), replace=False)
    checked = [dict(seed=images[i]["seed"], values=torch.from_numpy(images[i]["values"]),
                    **{k: images[i][k] for k in EVENTS + ("samples",)}) for i in sorted(picked)]
    paths = event_paths(cell.seed, w, h, spp, drawn["event_samples"])
    dev = cell.device

    def check(stand_in=None):
        """``drivers/render.py``'s check: with ``stand_in`` (a dtype), the
        reference computed in it stands in for the program's outputs."""
        rows, events = checked, checked[0]
        if stand_in is not None:
            scene = ref_scene.build(desc, cell.root, dev, stand_in)
            rows = reference_rows(scene, checked, pixels, w, h, spp, depth, dev, stand_in)
            events = reference_events(scene, checked[0]["seed"], paths, w, h, depth, dev,
                                      stand_in)
        scene = ref_scene.build(desc, cell.root, dev)
        ref_events = reference_events(scene, checked[0]["seed"], paths, w, h, depth, dev,
                                      torch.float32)
        return numbers(scene, rows, pixels, w, h, spp, depth, dev, res["failed"], events,
                       ref_events)

    res["check"] = check
    return res
