"""The drift between the port's two engines for mesh scenes, and its
tripwire.

Counterpart of ``tools/mesh_parity_probe.py``. The two engines are the
bounce kernel's mesh mode (``ops/bounce_kernel.bounce_trace``, a BVH walk
per ray inside the kernel) and the wavefront with the flash winner
(``render.wavefront_trace`` with ``tri_flash``: the flash kernel, every
bounce), both called directly on ``render()``'s lanes and flash planes.
Each engine runs twice (is it deterministic?), then their event counters
and images are compared. The two winners round the same way but cull
differently at grazing incidence (ROADMAP Queue 3 (g)), so a few paths
may part.

``--check`` holds the reference's envelope: each engine deterministic,
the largest event difference at most 5e-5 of the rays, and at most 1.5%
of the pixels differing by more than 1e-3 in a channel; it exits 1 with
a FAIL line otherwise.

    python -m zraytrace_tpu_torch.tools.mesh_parity_probe [--scene 4]
        [--spp 20] [--size 700] [--depth 20] [--check] [--cpu]

With ``--cpu`` both engines are the plain wavefront (the kernel's
wrapper runs its plain version on the host), so only the arithmetic is
exercised.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from zraytrace_tpu_torch.tools.common import card_info, pick_device

__all__ = ["ENGINES", "run_engine", "envelope", "probe", "main"]

ENGINES = ("kernel", "wavefront")


def run_engine(engine: str, built, params, device):
    """One render of ``built`` through ``engine`` on ``render()``'s lanes:
    ``(image (H, W, 3) numpy, (rays, reflections, background hits,
    recursion-depth hits))``."""
    from zraytrace_tpu_torch.ops.bounce_kernel import bounce_trace
    from zraytrace_tpu_torch.render import flash_pack_cached, wavefront_trace

    scene, camera = built.scene.to(device), built.camera.to(device)
    w, h, spp = params.width, params.height, params.samples_per_pixel
    n = w * h
    lanes = min(n, params.max_wavefront)
    slots = -(-n // lanes)
    planes = flash_pack_cached(scene)
    base = torch.arange(lanes, dtype=torch.int32, device=device)
    fn = bounce_trace if engine == "kernel" else wavefront_trace
    sums, counters = fn(scene, camera, base, params.seed, w, h, spp, params.max_depth, 0,
                        lanes, n, slots, tri_flash=planes)
    c = counters.cpu().tolist()
    image = (sums.reshape(slots * lanes, 3)[:n].cpu() / spp).reshape(h, w, 3).numpy()
    return image, tuple(c[:4])


def envelope(runs: dict, max_rel_events: float = 5e-5, max_pixel_frac: float = 0.015) -> dict:
    """The tripwire's arithmetic on ``runs``: engine -> two ``(image,
    counters)`` results. Returns whether each engine is deterministic,
    the largest event difference over the larger ray count
    (``rel_events``: per segment, not per counter, since recursion-depth
    hits are tens among millions of rays), the share of pixels whose
    largest channel differs by more than 1e-3, and ``ok``."""
    (img_k, c_k), (img_k2, c_k2) = runs["kernel"]
    (img_w, c_w), (img_w2, c_w2) = runs["wavefront"]
    det = {"kernel": c_k == c_k2 and bool((img_k == img_k2).all()),
           "wavefront": c_w == c_w2 and bool((img_w == img_w2).all())}
    rel_events = max(abs(a - b) for a, b in zip(c_k, c_w)) / max(c_k[0], c_w[0], 1)
    d = np.abs(img_k - img_w)
    bad = int((d.max(axis=-1) > 1e-3).sum())
    frac = bad / (d.shape[0] * d.shape[1])
    ok = all(det.values()) and rel_events <= max_rel_events and frac <= max_pixel_frac
    return dict(deterministic=det, counters={"kernel": list(c_k), "wavefront": list(c_w)},
                rel_events=rel_events, max_diff=float(d.max()), mean_diff=float(d.mean()),
                pixels_over=bad, pixel_frac=frac, max_rel_events=max_rel_events,
                max_pixel_frac=max_pixel_frac, ok=ok)


def probe(scene_idx: int = 4, spp: int = 20, size: int = 700, depth: int = 20,
          device="cuda", max_rel_events: float = 5e-5, max_pixel_frac: float = 0.015) -> dict:
    """Both engines twice on ``scene_idx``, then ``envelope``."""
    from zraytrace_tpu_torch.config import RenderParams
    from zraytrace_tpu_torch.scenes import build_scene

    device = torch.device(device)
    built = build_scene(scene_idx, device)
    params = RenderParams(width=size, height=size, samples_per_pixel=spp, max_depth=depth,
                          seed=42)
    runs = {e: [run_engine(e, built, params, device) for _ in range(2)] for e in ENGINES}
    return envelope(runs, max_rel_events, max_pixel_frac)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m zraytrace_tpu_torch.tools.mesh_parity_probe")
    ap.add_argument("--scene", type=int, default=4)
    ap.add_argument("--spp", type=int, default=20)
    ap.add_argument("--size", type=int, default=700)
    ap.add_argument("--depth", type=int, default=20)
    ap.add_argument("--check", action="store_true",
                    help="pass/fail against the envelope; exit 1 on any violation")
    ap.add_argument("--max-rel-events", type=float, default=5e-5)
    ap.add_argument("--max-pixel-frac", type=float, default=0.015)
    ap.add_argument("--cpu", action="store_true", help="run on the host (plain versions)")
    args = ap.parse_args(argv)
    device = pick_device(args.cpu)
    r = probe(args.scene, args.spp, args.size, args.depth, device, args.max_rel_events,
              args.max_pixel_frac)
    dev_name = card_info(device)["device"]
    for e in ENGINES:
        print(f"{e:9s} deterministic: {r['deterministic'][e]}", flush=True)
    ck, cw = r["counters"]["kernel"], r["counters"]["wavefront"]
    print(f"counters kernel={ck} wavefront={cw} drays={ck[0] - cw[0]} "
          f"rel={r['rel_events']:.2e} on {dev_name}", flush=True)
    print(f"image diff: max={r['max_diff']:.3e} mean={r['mean_diff']:.3e} pixels>1e-3: "
          f"{r['pixels_over']}/{args.size * args.size} ({100.0 * r['pixel_frac']:.3f}%)",
          flush=True)
    if args.check:
        print(f"{'PASS' if r['ok'] else 'FAIL'}: deterministic="
              f"{all(r['deterministic'].values())} rel_events={r['rel_events']:.2e}"
              f"<= {args.max_rel_events:.0e} pixel_frac={r['pixel_frac']:.4f}"
              f"<= {args.max_pixel_frac}", flush=True)
        return 0 if r["ok"] else 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
