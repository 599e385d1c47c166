"""Command line interface; counterpart of ``zraytrace_tpu/cli.py``.

Positional argument order matches the reference binary (main.zig:16):
``width height samples depth scene_index filename``; scenes 0-4 render
(5, goat, needs an asset that is absent upstream). Renders on the CUDA
device; ``--cpu`` renders with the plain PyTorch wavefront on the host.
With ``ZRAYTRACE_TRACE_DIR`` set, the render runs under a
``torch.profiler`` trace written there (``profiling.torch_trace``), the
program's spans as ranges around the kernels. The run ends with the span
report (``profiling.print_spans``).
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="zraytrace-tpu-torch",
        description="PyTorch / CUDA path tracer "
        "(usage mirrors the reference: main.zig:16)",
    )
    parser.add_argument("width", type=int)
    parser.add_argument("height", type=int)
    parser.add_argument("samples", type=int)
    parser.add_argument("depth", type=int)
    parser.add_argument("scene_index", type=int)
    parser.add_argument("filename")
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--no-bvh", action="store_true",
                        help="disable the BVH (raytrace.zig:102-108 flag); as in the JAX "
                             "package at its default bvh_min_triangles, the image and "
                             "counters do not change")
    parser.add_argument("--ppm", action="store_true",
                        help="also write a P3 PPM next to the PNG")
    parser.add_argument("--cpu", action="store_true",
                        help="render on the host CPU instead of the GPU")
    args = parser.parse_args(argv)

    from zraytrace_tpu_torch.config import RenderParams
    from zraytrace_tpu_torch.io.png import write_png
    from zraytrace_tpu_torch.io.ppm import write_ppm
    from zraytrace_tpu_torch.profiling import print_render_report, print_spans, span, torch_trace
    from zraytrace_tpu_torch.render import render
    from zraytrace_tpu_torch.scenes import build_scene

    device = "cpu" if args.cpu else "cuda"
    params = RenderParams(
        width=args.width,
        height=args.height,
        samples_per_pixel=args.samples,
        max_depth=args.depth,
        bvh=not args.no_bvh,
        seed=args.seed,
    )
    built = build_scene(args.scene_index, device)
    print(f"Rendering scene {built.name} on {device}", file=sys.stderr)
    print(f" - Surfaces:          {built.scene.n_primitives}", file=sys.stderr)
    print(f" - Pixels:            {params.width}x{params.height}", file=sys.stderr)
    print(f" - Samples per pixel: {params.samples_per_pixel}", file=sys.stderr)
    print(f" - Recursion depth:   {params.max_depth}", file=sys.stderr)

    with torch_trace(os.environ.get("ZRAYTRACE_TRACE_DIR")):
        image, stats = render(built.scene, built.camera, params, device)
    with span("cli.write"):
        write_png(args.filename, image.numpy())
        if args.ppm:
            write_ppm(str(args.filename) + ".ppm", image.numpy())

    print_render_report(stats)
    print("Spans:", file=sys.stderr)
    print_spans()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
