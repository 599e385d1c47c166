"""How many of a warp's issued lanes does the bounce kernel's loop keep
busy on scene 1 at depth 30? A host model from the paths themselves.

The port's own measurement (no TPU tool stands behind it). Every
(pixel, sample) path is traced on its own with the plain functions the
plain wavefront runs (``render.camera_rays``, ``trace_closest``,
``materials.scatter``, the same PCG4D streams), and its loop steps are
counted as the kernel counts them: one per traced segment, one more for
the depth check of a path that runs out of depth. The paths are then
grouped as ``render()`` gives them to the kernel (lane i holds pixels i,
i + n, ...; 32 consecutive lanes to a warp; lanes past the last pixel
idle), and the warp iterations of two loop shapes are counted:

- ``nested``: a sample loop around a depth loop. The warp runs each
  sample as long as its longest path: the sum over (slot, sample) of the
  warp's largest step count.
- ``segment``: one segment loop that starts a lane's next sample in
  place. The warp runs as long as its busiest lane: the largest sum of
  step counts.

SIMT efficiency is lane steps over (32 x warp iterations).
``--expected SPP`` also models the segment loop at SPP samples from the
traced ones: each pixel's expected steps per sample are its mean over
the traced samples, smoothed over 5 x 5 pixels, and a lane's steps are
SPP times that (the sum over many samples approaches its mean). The
nested loop's figure does not depend on the sample count.
``--warps N`` traces a sample of N warps (seeded) in place of the image.

    python -m zraytrace_tpu_torch.probes.simt_model [--cpu] [--width 1000] [--height 1000]
        [--spp 4] [--warps N] [--expected SPP]

Prints one ``[simt]`` line per figure and one JSON line. On the card the
paths are traced there; ``--cpu`` traces them on the host (small sizes).
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from zraytrace_tpu_torch import materials as mat
from zraytrace_tpu_torch import rng as zrng
from zraytrace_tpu_torch.render import camera_rays, trace_closest

__all__ = ["WARP", "path_steps", "warp_lanes", "simt_figures", "expected_segment", "main"]

WARP = 32
SEED = 42
SCENE, DEPTH = 1, 30  # scene 1 (spheres only) at the depth of its render
CHUNK = 1 << 21  # paths traced at once


def path_steps(scene, camera, pixels: torch.Tensor, width: int, height: int, spp: int,
               max_depth: int, seed: int = SEED, sample_start: int = 0) -> torch.Tensor:
    """The loop steps of every (pixel, sample) path: ``(len(pixels), spp)``
    int32, on the device of ``pixels``; the sum is the kernel's rays plus
    recursion-depth hits for the same pixels and samples."""
    dev = pixels.device
    n = pixels.shape[0]
    pix = pixels.to(torch.int32).repeat_interleave(spp)
    samp = (torch.arange(spp, dtype=torch.int32, device=dev) + sample_start).repeat(n)
    steps = torch.zeros((n * spp,), dtype=torch.int32, device=dev)
    for lo in range(0, n * spp, CHUNK):
        idx = torch.arange(lo, min(lo + CHUNK, n * spp), device=dev)
        p, s = pix[idx], samp[idx]
        o, d = camera_rays(camera, seed, p, s, width, height)
        depth = 0
        while idx.numel():
            steps[idx] += 1
            if depth >= max_depth:  # the depth check ends every path left
                break
            h = trace_closest(scene, o, d)
            rnd = zrng.uniform4(seed, p, s, depth, zrng.STREAM_SCATTER)
            new_dir, _, absorbed = mat.scatter(scene, d, h["normal"], h["front_face"], h["uv"],
                                               h["mat_id"], rnd)
            go = h["hit"] & ~absorbed
            idx, p, s = idx[go], p[go], s[go]
            o, d = h["point"][go], new_dir[go]
            depth += 1
    return steps.reshape(n, spp)


def warp_lanes(n_pixels: int) -> tuple[int, int]:
    """``render()``'s lanes for an image: (lanes, slots per lane)."""
    n = min(n_pixels, 1 << 20)
    return n, -(-n_pixels // n)


def simt_figures(steps: np.ndarray, n_lanes: int) -> dict:
    """The two loop shapes' warp iterations and SIMT efficiency for the
    step counts of every pixel (``(n_pixels, spp)``, in pixel order) on
    ``n_lanes`` lanes (pixel p on lane p % n_lanes, slot p // n_lanes)."""
    n_pix, spp = steps.shape
    slots = -(-n_pix // n_lanes)
    n_warps = -(-n_lanes // WARP)
    grid = np.zeros((slots * n_lanes, spp), np.int64)  # (slot, lane) order, idle lanes 0
    grid[:n_pix] = steps
    grid = np.pad(grid.reshape(slots, n_lanes, spp), ((0, 0), (0, n_warps * WARP - n_lanes),
                                                      (0, 0)))
    grid = grid.reshape(slots, n_warps, WARP, spp)
    lane_steps = int(grid.sum())
    nested = int(grid.max(axis=2).sum())
    segment = int(grid.sum(axis=(0, 3)).max(axis=1).sum())
    return dict(lane_steps=lane_steps, n_warps=n_warps, nested_iters=nested,
                segment_iters=segment, nested=lane_steps / (WARP * nested),
                segment=lane_steps / (WARP * segment), ratio=nested / segment)


def expected_segment(steps: np.ndarray, width: int, height: int, spp: int) -> dict:
    """The segment loop at ``spp`` samples, modelled from an image's step
    counts (``(width * height, traced spp)``): per pixel the mean steps
    per sample smoothed over 5 x 5 pixels (edges clamped), times ``spp``."""
    if warp_lanes(width * height)[1] != 1:
        raise ValueError("the expected-steps model takes one pixel per lane")
    mean = steps.mean(axis=1).reshape(height, width)
    padded = np.pad(mean, 2, mode="edge")
    smooth = sum(padded[dy:dy + height, dx:dx + width] for dy in range(5) for dx in range(5)) / 25
    lanes = np.zeros((-(-width * height // WARP) * WARP,))
    lanes[:width * height] = smooth.reshape(-1) * spp
    per_warp = lanes.reshape(-1, WARP)
    return dict(spp=spp, segment=float(per_warp.sum() / (WARP * per_warp.max(axis=1).sum())))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true", help="trace on the host")
    ap.add_argument("--width", type=int, default=1000)
    ap.add_argument("--height", type=int, default=1000)
    ap.add_argument("--spp", type=int, default=4)
    ap.add_argument("--warps", type=int, default=0, help="trace a seeded sample of warps")
    ap.add_argument("--expected", type=int, default=0, help="model the segment loop at SPP")
    args = ap.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        print("simt_model: needs a CUDA device (or --cpu)", file=sys.stderr)
        return 2
    from zraytrace_tpu_torch.probes.common import card_line
    from zraytrace_tpu_torch.scenes import build_scene

    dev = torch.device("cpu") if args.cpu else torch.device("cuda", 0)
    where = "host" if args.cpu else card_line()
    b = build_scene(SCENE, dev)
    w, h, spp = args.width, args.height, args.spp
    n_lanes, _ = warp_lanes(w * h)
    if args.warps:
        pick = np.sort(np.random.default_rng(SEED).choice(-(-n_lanes // WARP), args.warps,
                                                          replace=False))
        lanes = (pick[:, None] * WARP + np.arange(WARP)).reshape(-1)
        pixels = torch.from_numpy(lanes[lanes < min(n_lanes, w * h)]).to(dev)
    else:
        pixels = torch.arange(w * h, device=dev)
    steps = path_steps(b.scene, b.camera, pixels, w, h, spp, DEPTH).cpu().numpy()
    if args.warps:
        full = np.zeros((-(-len(pixels) // WARP) * WARP, spp), np.int64)
        full[:len(pixels)] = steps
        fig = simt_figures(full, len(full))  # the sampled warps side by side
    else:
        fig = simt_figures(steps, n_lanes)
    print(f"[simt] scene {SCENE} {w}x{h}x{spp} d{DEPTH}"
          f"{f' ({args.warps} sampled warps)' if args.warps else ''}: {fig['lane_steps']} lane "
          f"steps ({fig['lane_steps'] / steps.size:.3f} per path, at most {steps.max()}); "
          f"sample loop around a depth loop {fig['nested_iters']} warp iterations, SIMT "
          f"{fig['nested']:.4f}; one segment loop {fig['segment_iters']}, SIMT "
          f"{fig['segment']:.4f}; {fig['ratio']:.3f}x the iterations; traced on {where}",
          flush=True)
    out = dict(scene=SCENE, width=w, height=h, spp=spp, depth=DEPTH, warps=args.warps,
               where=where, max_steps=int(steps.max()), **fig)
    if args.expected:
        if args.warps:
            ap.error("--expected models the whole image")
        e = expected_segment(steps, w, h, args.expected)
        print(f"[simt] scene {SCENE} {w}x{h}x{args.expected} d{DEPTH}, expected "
              f"steps from {spp} spp smoothed over 5x5 pixels: one segment loop SIMT "
              f"{e['segment']:.4f}; nested {fig['nested']:.4f} (independent of spp), "
              f"{e['segment'] / fig['nested']:.3f}x the iterations", flush=True)
        out["expected"] = e
    print(json.dumps({"simt_model": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
