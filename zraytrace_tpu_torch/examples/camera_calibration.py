"""Camera calibration: recover the camera's position (and, with
``--free-vfov``, its field of view) from a target image.

Counterpart of ``examples/camera_calibration.py``. ``camera.make_camera``
is differentiable, so ``look_from`` and ``vfov`` are parameters like any
of the scene's. A translation of the camera moves the whole image, so the
signal is in the silhouettes, where the interior gradient is nearly
blind; with three scalars, correlated central differences
(``inverse.fd_gradients``: 2 renders per scalar, exact under the
stateless RNG) are cheap. Adam at lr 1e-2 with optax's constants.

The scene: two matte balls and a mirror ball on a green ground, seen from
(0.4, 0.3, -5) at 45 degrees; the fit starts 0.2, -0.15, 0.3 away (and 4
degrees wide with ``--free-vfov``, where distance and field of view sit
in the dolly-zoom valley, so the loss converges and the pose need not).
Recovery is OK when the last loss is below a quarter of the first and
the position is within 0.2 of the truth.

    python -m zraytrace_tpu_torch.examples.camera_calibration [--steps 400]
        [--size 24] [--spp 8] [--free-vfov] [--out PREFIX] [--cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from zraytrace_tpu_torch.tools.common import card_info, pick_device, wall

__all__ = ["TRUE_FROM", "LOOK_AT", "TRUE_VFOV", "DEPTH", "SEED", "calibration_scene", "run",
           "main"]

TRUE_FROM = (0.4, 0.3, -5.0)
LOOK_AT = (0.0, 0.0, 1.0)
TRUE_VFOV = 45.0
DEPTH = 4
SEED = 7


def calibration_scene(device):
    """Two matte balls and a mirror ball on the ground sphere: enough
    parallax to pin the camera."""
    from zraytrace_tpu_torch import scene as sc

    b = sc.SceneBuilder()
    red = b.add_lambertian_color((0.8, 0.2, 0.1))
    blue = b.add_lambertian_color((0.15, 0.3, 0.75))
    silver = b.add_metal_color(sc.COLOR_SILVER)
    green = b.add_lambertian_color(sc.COLOR_GREEN)
    b.add_sphere((-1.1, 0.0, 3.0), 0.9, red)
    b.add_sphere((1.2, -0.2, 4.0), 0.7, blue)
    b.add_sphere((0.1, 0.5, 6.0), 1.0, silver)
    b.add_sphere((0.0, -51.0, 4.0), 50.0, green)
    return b.build(device)


def run(argv=None) -> dict:
    """Parse ``argv`` and run the calibration: returns the losses, the
    target image, the recovered pose, its error, ``ok``, the wall seconds
    and the device."""
    ap = argparse.ArgumentParser(
        prog="python -m zraytrace_tpu_torch.examples.camera_calibration")
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--size", type=int, default=24)
    ap.add_argument("--spp", type=int, default=8)
    ap.add_argument("--cpu", action="store_true", help="run on the host, not the card")
    ap.add_argument("--out", default=None, help="write target and recovered PNGs")
    ap.add_argument("--free-vfov", action="store_true",
                    help="also fit vfov (the dolly-zoom ambiguity: the loss converges, the "
                         "pose need not)")
    args = ap.parse_args(argv)
    device = pick_device(args.cpu)

    from zraytrace_tpu_torch.camera import make_camera
    from zraytrace_tpu_torch.inverse import fd_gradients
    from zraytrace_tpu_torch.render_diff import render_diff

    scene = calibration_scene(device)
    w = h = args.size

    def render_at(p):
        camera = make_camera(p["look_from"], LOOK_AT, (0.0, 1.0, 0.0), p["vfov"], 1.0,
                             device=device)
        return render_diff(scene, camera, w, h, args.spp, DEPTH, seed=SEED)

    true_from = torch.tensor(TRUE_FROM, dtype=torch.float32)
    true_vfov = torch.tensor(TRUE_VFOV, dtype=torch.float32)
    with torch.no_grad():
        target = render_at({"look_from": true_from, "vfov": true_vfov})

    params = {"look_from": true_from + torch.tensor((0.2, -0.15, 0.3)),
              "vfov": true_vfov + (4.0 if args.free_vfov else 0.0)}
    fields = ("look_from", "vfov") if args.free_vfov else ("look_from",)
    opt = torch.optim.Adam(list(params.values()), lr=1e-2, betas=(0.9, 0.999), eps=1e-8)

    def loss_fn(p):
        return ((render_at(p) - target) ** 2).mean()

    def fit():
        losses = []
        for _ in range(args.steps):
            with torch.no_grad():
                losses.append(float(loss_fn(params)))
            grads = fd_gradients(loss_fn, params, fields)
            for k, v in params.items():
                v.grad = grads[k] if k in grads else torch.zeros_like(v)
            opt.step()
        return losses

    losses, seconds = wall(fit, device)
    rec_f = params["look_from"].numpy()
    rec_v = float(params["vfov"])
    dev = card_info(device)
    print(f"loss: {losses[0]:.6f} -> {losses[-1]:.6f} ({args.steps} steps, {seconds:.2f} s, "
          f"{seconds / max(args.steps, 1):.3f} s/step on {dev['device']})")
    print(f"look_from: true (+0.400, +0.300, -5.000)  recovered "
          f"({rec_f[0]:+.3f}, {rec_f[1]:+.3f}, {rec_f[2]:+.3f})")
    print(f"vfov:      true 45.00                     recovered {rec_v:.2f}")

    if args.out:
        from zraytrace_tpu_torch.io.png import write_png

        with torch.no_grad():
            write_png(args.out + ".target.png", target.cpu().numpy())
            write_png(args.out + ".recovered.png", render_at(params).cpu().numpy())

    pos_err = float(np.linalg.norm(rec_f - np.asarray(TRUE_FROM, np.float32)))
    ok = bool(losses[-1] < losses[0] * 0.25 and pos_err < 0.2)
    print(f"RECOVERY {'OK' if ok else 'INCOMPLETE'} (pos err {pos_err:.3f})")
    return dict(losses=np.asarray(losses), target=target.cpu(), look_from=rec_f, vfov=rec_v,
                pos_err=pos_err, ok=ok, seconds=seconds, steps=args.steps, **dev)


def main(argv=None) -> int:
    return 0 if run(argv)["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
