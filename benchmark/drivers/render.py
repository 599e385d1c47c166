"""Traffic of ``kind`` ``render``: a closed loop of ``render.render`` calls,
one image after another, each with a seed of its own drawn from the run's
seed and the image's index, at the configuration's ``render`` sizes.

Each image is timed from the call until its image tensor is on the host.
The check draws from the seed a set of pixels and a set of the window's
images, and holds the program's values at those pixels to the
reference's; and the first checked image's event counts per sample to
the reference's over every pixel of it, ``event_samples`` samples of each
drawn from the seed.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from benchmark import devtrace
from benchmark.drivers import closed_loop, sync
from benchmark.reference import render as ref_render
from benchmark.reference import scene as ref_scene

EVENTS = ("rays", "reflections", "background_hits")


WINDOW, WARM_UP, PROFILED = 0, 1, 2


def image_seed(seed: int, use: int, i: int) -> int:
    """The seed of image ``i`` of a run with ``seed``, for the window,
    the warm-up or the profiler pass (``use``): 32 bits drawn from all
    three."""
    return int(np.random.SeedSequence([seed % 2**64, use, i]).generate_state(1)[0])


def window_metrics(images: list, window_s: float) -> dict:
    """``rays_per_s``: every image's rays over the window's seconds;
    ``image_p95_ms``: the 95th percentile (linear between ranks) of every
    image's seconds, in ms."""
    return dict(rays_per_s=sum(im["rays"] for im in images) / window_s,
                image_p95_ms=float(np.percentile([im["seconds"] for im in images], 95)) * 1e3)


def program_scene(desc: dict, device):
    """The program's scene and camera, from the builder the scene's
    description names in ``program``."""
    from zraytrace_tpu_torch import scenes

    prog = desc["program"]
    return getattr(scenes, prog["builder"])(*prog.get("args", ()), device=device)


def run(cell) -> dict:
    from zraytrace_tpu_torch.config import RenderParams
    from zraytrace_tpu_torch.render import render

    dev = cell.device
    rc = cell.config["render"]
    desc = cell.config["scenes"][rc["scene"]]
    w, h, spp, depth = rc["width"], rc["height"], rc["spp"], rc["depth"]
    check = cell.traffic["check"]
    pixels = np.sort(np.random.default_rng([cell.seed % 2**64, 1]).choice(
        w * h, size=min(check["pixels"], w * h), replace=False))
    pix_t = torch.as_tensor(pixels)
    built = program_scene(desc, dev)

    def one(seed):
        t0 = time.perf_counter()
        img, st = render(built.scene, built.camera,
                         RenderParams(width=w, height=h, samples_per_pixel=spp, max_depth=depth,
                                      seed=seed), dev)
        return img, st, time.perf_counter() - t0

    one(image_seed(cell.seed, WARM_UP, 0))  # every shape of the window, built and warmed: set-up
    sync(dev)
    setup_end = time.perf_counter()

    def record(i):
        seed = image_seed(cell.seed, WINDOW, i)
        img, st, sec = one(seed)
        return dict(seed=seed, seconds=sec, values=img.reshape(-1, 3)[pix_t].clone(),
                    rays=st.rays, reflections=st.reflections, background_hits=st.background_hits,
                    recursion_depth_hits=st.recursion_depth_hits, samples=st.samples,
                    preprocess_s=st.preprocess_seconds, transfer_s=st.transfer_seconds,
                    ok=(st.samples == w * h * spp
                        and st.rays == st.reflections + st.samples - st.recursion_depth_hits))

    images, window_s = closed_loop(record, cell.seconds, dev)
    res = dict(setup_end=setup_end, window_s=window_s, images=images, attempted=len(images),
               failed=sum(not im["ok"] for im in images), width=w, height=h,
               metrics=window_metrics(images, window_s))
    if cell.trace:
        seeds = [image_seed(cell.seed, PROFILED, k) for k in range(cell.traffic["profile_images"])]
        it = iter(seeds)
        out, res["profile"] = devtrace.profiled(lambda: one(next(it)), len(seeds), dev)
        res["profiled_images"] = [dict(rays=st.rays, reflections=st.reflections,
                                       background_hits=st.background_hits,
                                       recursion_depth_hits=st.recursion_depth_hits,
                                       samples=st.samples) for _, st, _ in out]
    picked = np.random.default_rng([cell.seed % 2**64, 2]).choice(
        len(images), size=min(check["images"], len(images)), replace=False)
    checked = [dict(seed=images[i]["seed"], values=images[i]["values"],
                    **{k: images[i][k] for k in EVENTS + ("samples",)}) for i in sorted(picked)]
    paths = event_paths(cell.seed, w, h, spp, check["event_samples"])

    def check(stand_in=None):
        """The check's numbers, the program's scene freed first; with
        ``stand_in`` (a dtype), the reference computed in it stands in for
        the program's outputs (the control): its values at the pixels, and
        its event counts over the paths as the first image's."""
        nonlocal built
        built = None
        rows, events = checked, checked[0]
        if stand_in is not None:
            scene = ref_scene.build(desc, cell.root, dev, stand_in)
            rows = reference_rows(scene, checked, pixels, w, h, spp, depth, dev, stand_in)
            events = reference_events(scene, checked[0]["seed"], paths, w, h, depth, dev,
                                      stand_in)
        scene = ref_scene.build(desc, cell.root, dev)
        ref_events = reference_events(scene, checked[0]["seed"], paths, w, h, depth, dev,
                                      torch.float32)
        return numbers(scene, rows, pixels, w, h, spp, depth, dev, res["failed"],
                       events, ref_events)

    res["check"] = check
    return res


def event_paths(seed: int, w: int, h: int, spp: int, per_pixel: int) -> tuple:
    """``(pixel, sample)`` of ``per_pixel`` paths of every pixel: a sample
    drawn from the seed for each pixel, and the others spread evenly from
    it over the pixel's ``spp`` (with ``per_pixel = spp``, every path)."""
    first = np.random.default_rng([seed % 2**64, 3]).integers(0, spp, size=w * h)
    pixel = np.tile(np.arange(w * h), per_pixel)
    sample = np.concatenate([(first + j * (spp // per_pixel)) % spp for j in range(per_pixel)])
    return torch.as_tensor(pixel), torch.as_tensor(sample)


def reference_events(scene, seed, paths, w, h, depth, dev, dtype) -> dict:
    """The reference's event counts over ``paths`` of the image ``seed``."""
    pixel, sample = (t.to(dev) for t in paths)
    return ref_render.path_counts(scene, seed, pixel, sample, w, h, depth, dtype)


def reference_rows(scene, checked, pixels, w, h, spp, depth, dev, dtype) -> list:
    """The reference's values and event counts at ``pixels`` of each
    checked image, in the layout of the program's rows."""
    pix = torch.as_tensor(pixels, device=dev)
    rows = []
    for row in checked:
        vals, counts = ref_render.render_pixels(scene, row["seed"], pix, w, h, spp, depth, dtype)
        rows.append(dict(seed=row["seed"], values=vals.float().cpu(), **counts))
    return rows


def numbers(scene, prog_rows, pixels, w, h, spp, depth, dev, failed: int, events: dict,
            ref_events: dict) -> dict:
    """``image_gap``: the mean absolute difference of the program's values
    from the reference's over the checked pixels of the checked images;
    ``identity_misses``: the window's images whose counters break
    ``samples = w h spp`` or ``rays = reflections + samples -
    recursion-depth hits``; ``event_gap``: over ``EVENTS``, the largest
    relative difference of ``events`` per sample (the program's whole
    image) from ``ref_events`` per sample (the reference's paths)."""
    ref = reference_rows(scene, prog_rows, pixels, w, h, spp, depth, dev, torch.float32)
    gaps = [(p["values"].float() - r["values"]).abs().mean().item()
            for p, r in zip(prog_rows, ref)]
    rate = lambda c, k: c[k] / c["samples"]
    print("# events per sample, program / reference: " + ", ".join(
        f"{k} {rate(events, k):.9g} / {rate(ref_events, k):.9g}" for k in EVENTS),
        file=sys.stderr)
    event_gap = max(abs(rate(events, k) - rate(ref_events, k)) / rate(ref_events, k)
                    for k in EVENTS)
    return dict(image_gap=float(np.mean(gaps)), identity_misses=failed, event_gap=event_gap)
