"""Read the per-event prices that ``configs/<config>.json`` freezes under
``work`` (how they were made; no benchmark run calls this).

    python3 -m benchmark.pricing --config threeBalls --seed 1

renders the configuration's ``render`` image once through the bounce
kernel's counting build (``bounce_trace(..., work=)``) on the card and
prices the work it counted with the program's stage prices
(``zraytrace_tpu_torch/probes/bounds.py``). It prints the counters, the
work counts and ``ops_per_event``: a sample's camera ray, a background
hit's sky in place of a hit's shading, and the rest per ray, so that the
prices times these counters give the counted operations exactly.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch

from benchmark.drivers.render import program_scene


def main(argv=None) -> int:
    from zraytrace_tpu_torch.config import RenderParams
    from zraytrace_tpu_torch.ops.bounce_kernel import WORK_FIELDS, bounce_trace
    from zraytrace_tpu_torch.probes import bounds
    from zraytrace_tpu_torch.render import lanes, mesh_routing

    ap = argparse.ArgumentParser(prog="python3 -m benchmark.pricing")
    ap.add_argument("--config", required=True)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    root = Path(__file__).resolve().parent
    cfg = json.loads((root / "configs" / f"{args.config}.json").read_text())
    rc = cfg["render"]
    dev = torch.device("cuda", 0)
    built = program_scene(cfg["scenes"][rc["scene"]], dev)
    route = mesh_routing(built.scene, dev)
    lay = lanes(rc["width"], rc["height"], RenderParams().max_wavefront, dev)
    work = torch.zeros((len(WORK_FIELDS),), dtype=torch.int64, device=dev)
    _, counters = bounce_trace(built.scene, built.camera, lay.base, args.seed, rc["width"],
                               rc["height"], rc["spp"], rc["depth"], 0, lay.n_lanes,
                               lay.n_pixels, lay.n_slots, tri_flash=route.tri_flash, work=work)
    c = counters.tolist()
    w = dict(zip(WORK_FIELDS, work.tolist()))
    mesh = built.scene.n_triangles > 0
    flops = bounds.bounce_flops(c, built.scene.n_spheres, w, mesh)
    rays, _, bg, _, samples, _ = c
    per_bg = bounds.MISS_FLOPS - bounds.HIT_FLOPS - bounds.SPHERE_NORMAL_FLOPS
    per_sample = bounds.CAMERA_FLOPS
    per_ray = (flops - samples * per_sample - bg * per_bg) / rays
    print(json.dumps(dict(
        config=args.config, seed=args.seed, counters=dict(zip(
            ("rays", "reflections", "background_hits", "recursion_depth_hits", "samples",
             "wavefront_iterations"), c)),
        work=w, ops=flops, device=torch.cuda.get_device_name(0),
        ops_per_event=dict(samples=per_sample, background_hits=per_bg, rays=per_ray))))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
