"""The occlusion term's gradient quality at mesh scale.

Counterpart of ``tools/occl_grad_probe.py``. At a pose offset of the
teapot on the ground (the pose fit's scene), d loss / d offset from the
edge-aware estimator with the occlusion term off, on camera segments only
and on every bounce, against central finite differences of the unrelaxed
forward (no edge factors: exact under the stateless RNG, the same streams
on both sides). Per scale it prints the FD vector, and per mode the
gradient, its cosine with FD and the ratio of their norms, so bias,
variance and a wrong basin can be told apart. On the card every bounce
launches the flash kernel (the winner pass) and, with edge factors, the
margin kernel.

    python -m zraytrace_tpu_torch.tools.occl_grad_probe [--scale 1.0 0.5]
        [--size 64] [--spp 8] [--depth 4] [--eps 0.015] [--fd-h 0.02] [--cpu]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from zraytrace_tpu_torch.tools.common import card_info, pick_device

__all__ = ["MODES", "INIT", "probe", "main"]

MODES = (("off", False), ("camera", "camera"), ("all", True))
INIT = (0.5, -0.35, 0.45)  # examples/mesh_fit.py's initial offset, per unit scale


def probe(scales=(1.0, 0.5), size: int = 64, spp: int = 8, depth: int = 4, eps: float = 0.015,
          fd_h: float = 0.02, device="cuda", verbose: bool = True) -> list[dict]:
    """One dict per scale: ``scale``, ``fd`` (3,), and per mode ``grad``,
    ``cos`` and ``ratio``."""
    from zraytrace_tpu_torch.geometry.bvh import build_tri_bvh
    from zraytrace_tpu_torch.kernel_inputs import pose_image
    from zraytrace_tpu_torch.scenes import teapot_on_ground

    device = torch.device(device)
    b = teapot_on_ground(device)
    base, camera = b.scene, b.camera
    order = build_tri_bvh(base.tri_a, base.tri_b, base.tri_c).prim_order.to(device)
    dims = dict(width=size, height=size, spp=spp, depth=depth)

    def image(off, occ, e):
        return pose_image(base, camera, order, off, e, occlusion=occ, **dims)

    zero = torch.zeros(3, dtype=torch.float32, device=device)
    with torch.no_grad():
        target = image(zero, False, None)

    def loss(off, occ, e):
        return ((image(off, occ, e) - target) ** 2).mean()

    out = []
    for s in scales:
        off = torch.tensor(INIT, dtype=torch.float32, device=device) * s
        fd = []
        with torch.no_grad():
            for ax in range(3):
                e = torch.zeros(3, dtype=torch.float32, device=device)
                e[ax] = fd_h
                fd.append((float(loss(off + e, False, None)) - float(loss(off - e, False, None)))
                          / (2 * fd_h))
        fd = np.asarray(fd)
        row = dict(scale=s, fd=fd.tolist(), modes={})
        if verbose:
            print(f"scale={s}  fd={np.array2string(fd, precision=5)}", flush=True)
        for name, occ in MODES:
            x = off.clone().requires_grad_(True)
            loss(x, occ, eps).backward()
            g = x.grad.cpu().numpy().astype(np.float64)
            cos = float(g @ fd / (np.linalg.norm(g) * np.linalg.norm(fd) + 1e-30))
            ratio = float(np.linalg.norm(g) / (np.linalg.norm(fd) + 1e-30))
            row["modes"][name] = dict(grad=g.tolist(), cos=cos, ratio=ratio)
            if verbose:
                print(f"  occ={name:6s} g={np.array2string(g, precision=5)} cos={cos:+.3f} "
                      f"|g|/|fd|={ratio:.2f}", flush=True)
        out.append(row)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m zraytrace_tpu_torch.tools.occl_grad_probe")
    ap.add_argument("--scale", type=float, nargs="*", default=[1.0, 0.5])
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--spp", type=int, default=8)
    ap.add_argument("--depth", type=int, default=4)
    ap.add_argument("--eps", type=float, default=0.015)
    ap.add_argument("--fd-h", type=float, default=0.02)
    ap.add_argument("--cpu", action="store_true", help="run on the host, not the card")
    args = ap.parse_args(argv)
    device = pick_device(args.cpu)
    rows = probe(args.scale, args.size, args.spp, args.depth, args.eps, args.fd_h, device)
    print(json.dumps({"occl_grad_probe": rows, **card_info(device)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
