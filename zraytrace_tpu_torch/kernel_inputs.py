"""The inputs the main paths give the flash winner and the margin selection.

``chip_smoke.py`` drives and checks the kernels on them, and
``probes/winner_lanes.py`` times the kernels of one checkout against
another's on the same inputs:

- the teapot pose fit's configuration (``tools/diff_bench.py``
  ``teapot_pose_fit``: 64x64, 8 spp, depth 4, ``edge_eps=(0.015, 0.03)``,
  from the offset ``POSE_START``), its image (``pose_image``), loss
  (``pose_loss``) and Adam step (``pose_adam_step``), the step that
  ``chip_smoke.py`` phase 10 checks and ``tools/diff_bench.py`` times;
- ``recorded_calls``: every call of the two kernels' wrappers, with its
  inputs, and optionally CUDA events around it; ``pose_step_calls``: those
  of one pose step's forward (4 of each kernel, one a bounce, on the
  32,768 lanes of its 8 samples);
- ``scene3_rays``: scene 3's camera rays and one bounce of them, seeded
  with the sphere t (``chip_smoke.py`` phase 5);
- ``margin_rays``: the pose-fit scene's camera rays and rays leaving the
  teapot's surface, capped by the closest hit (phase 9).
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch

from zraytrace_tpu_torch import materials as mat
from zraytrace_tpu_torch import rng as zrng
from zraytrace_tpu_torch import vecmath as vm
from zraytrace_tpu_torch.geometry.bvh import build_tri_bvh
from zraytrace_tpu_torch.geometry.sphere import BIG, intersect_spheres
from zraytrace_tpu_torch.ops import flash_intersect as fi
from zraytrace_tpu_torch.profiling import span
from zraytrace_tpu_torch.render import camera_rays, trace_closest
from zraytrace_tpu_torch.render_diff import render_diff
from zraytrace_tpu_torch.scenes import teapot_on_ground
from zraytrace_tpu_torch.transforms import Pose, transform_triangles

__all__ = ["SEED", "T_MIN", "POSE", "POSE_EPS", "POSE_START", "POSE_LR", "KernelCall",
           "pose_image", "pose_loss", "pose_adam_step", "recorded_calls", "launch",
           "pose_step_calls", "scene3_rays", "margin_rays"]

SEED = 42
T_MIN = 1e-3
POSE = dict(width=64, height=64, spp=8, depth=4)  # teapot_pose_fit
POSE_EPS = 0.015  # edge_eps (eps, 2 eps)
POSE_START = (0.25, -0.18, 0.22)
POSE_LR = 2e-2  # Adam's learning rate
# the flash module's wrapper of each kernel
WRAPPERS = {"flash_intersect": "flash_intersect_triangles",
            "flash_margins": "flash_margin_select"}


class KernelCall(NamedTuple):
    """One wrapper call's inputs, contiguous: ``x`` is the flash winner's
    ``t_init`` (or None) or the margin selection's ``t_cap``."""
    planes: fi.TriPlanes
    o: torch.Tensor
    d: torch.Tensor
    x: torch.Tensor | None
    t_min: float


def pose_image(base, camera, order, off, eps: float | None, screen: bool = False,
               occlusion=False, width: int | None = None, height: int | None = None,
               spp: int | None = None, depth: int | None = None, pair: bool = True):
    """The pose fit's image of ``base`` moved by ``off`` (each of width,
    height, spp and depth ``POSE``'s unless given), its planes repacked
    in the BVH ``order`` with no gradient from the moved vertices; edge
    factors at ``(eps, 2 eps)`` (``eps`` alone without ``pair``), none
    for ``eps=None``."""
    width, height, spp, depth = (POSE[k] if v is None else v for k, v in (
        ("width", width), ("height", height), ("spp", spp), ("depth", depth)))
    dev = off.device
    scene = transform_triangles(base, Pose(off, torch.zeros(3, device=dev),
                                           torch.ones((), device=dev)))
    with torch.no_grad(), span("diff.pack"):
        planes = fi.pack_tri_planes(scene.tri_a.detach(), scene.tri_b.detach(),
                                    scene.tri_c.detach(), order=order)
    return render_diff(scene, camera, width, height, spp, depth, seed=SEED, mesh_fast=True,
                       tri_flash=planes,
                       edge_eps=(eps, 2.0 * eps) if pair and eps is not None else eps,
                       edge_occlusion=occlusion, edge_screen=screen)


@span("fit.loss")
def pose_loss(base, camera, order, off, target, **dims):
    """The pose fit's loss: the mean squared difference of ``pose_image``
    at ``off`` (edge factors at ``(POSE_EPS, 2 POSE_EPS)``) from
    ``target``; ``dims`` as ``pose_image``'s. A ``fit.loss`` span."""
    return ((pose_image(base, camera, order, off, POSE_EPS, **dims) - target) ** 2).mean()


def pose_adam_step(base, camera, order, target, **dims):
    """One Adam step of the pose fit from ``POSE_START`` (optax's
    ``adam`` at ``POSE_LR``: betas (0.9, 0.999), eps 1e-8), on state of
    its own. Returns ``(step, off)``: ``step()`` takes a step and returns
    its loss, and leaves its gradient in ``off.grad``."""
    off = torch.tensor(POSE_START, dtype=torch.float32, device=target.device,
                       requires_grad=True)
    opt = torch.optim.Adam([off], lr=POSE_LR, betas=(0.9, 0.999), eps=1e-8)

    def step():
        opt.zero_grad(set_to_none=True)
        loss = pose_loss(base, camera, order, off, target, **dims)
        loss.backward()
        opt.step()
        return loss.detach()

    return step, off


@contextlib.contextmanager
def recorded_calls(calls: dict, events: dict | None = None):
    """Record every call of the two kernels' wrappers while the block runs:
    ``calls[kernel]`` collects a ``KernelCall`` per call and, where
    ``events`` is given, ``events[kernel]`` the CUDA events recorded just
    before and just after it."""
    saved = {k: getattr(fi, attr) for k, attr in WRAPPERS.items()}

    def contig(x):
        return None if x is None else x.contiguous()

    def record(name, planes, o, d, x, t_min, run):
        calls.setdefault(name, []).append(
            KernelCall(planes, o.contiguous(), d.contiguous(), contig(x), float(t_min)))
        if events is None:
            return run()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = run()
        end.record()
        events.setdefault(name, []).append((start, end))
        return out

    def flash(planes, o, d, t_min, t_init=None, work=None):
        return record("flash_intersect", planes, o, d, t_init, t_min,
                      lambda: saved["flash_intersect"](planes, o, d, t_min, t_init, work))

    def margins(planes, o, d, t_cap, t_min, work=None):
        return record("flash_margins", planes, o, d, t_cap, t_min,
                      lambda: saved["flash_margins"](planes, o, d, t_cap, t_min, work))

    fi.flash_intersect_triangles, fi.flash_margin_select = flash, margins
    try:
        yield
    finally:
        for name, attr in WRAPPERS.items():
            setattr(fi, attr, saved[name])


def launch(kernel: str, c: KernelCall, work=None):
    """Call ``kernel``'s wrapper on the recorded inputs ``c``."""
    if kernel == "flash_intersect":
        return fi.flash_intersect_triangles(c.planes, c.o, c.d, c.t_min, c.x, work=work)
    return fi.flash_margin_select(c.planes, c.o, c.d, c.x, c.t_min, work=work)


def pose_step_calls(dev) -> dict:
    """The wrapper calls of one teapot pose step's forward from
    ``POSE_START``: ``{"flash_intersect": [KernelCall], "flash_margins":
    [...]}``, one of each per bounce and sample group."""
    b = teapot_on_ground(dev)
    order = build_tri_bvh(b.scene.tri_a, b.scene.tri_b, b.scene.tri_c).prim_order.to(dev)
    off = torch.tensor(POSE_START, device=dev, requires_grad=True)
    calls = {}
    with recorded_calls(calls):
        pose_image(b.scene, b.camera, order, off, POSE_EPS)
    return calls


def scene3_rays(b, dev, w: int = 700, h: int = 700):
    """``(o, d, t_init)`` of scene 3 (``b``, from ``build_scene(3)``): its
    ``w x h`` camera rays and one bounce of those that hit (the brute-force
    query's hits, scattered), seeded with the sphere t."""
    s3 = b.scene
    pix = torch.arange(w * h, dtype=torch.int32, device=dev)
    zero = torch.zeros_like(pix)
    o0, d0 = camera_rays(b.camera, SEED, pix, zero, w, h)
    hit0 = trace_closest(s3, o0, d0)
    rnd = zrng.uniform4(SEED, pix, zero, zero, zrng.STREAM_SCATTER)
    d1, _, absorbed = mat.scatter(s3, d0, hit0["normal"], hit0["front_face"], hit0["uv"],
                                  hit0["mat_id"], rnd)
    go_on = hit0["hit"] & ~absorbed
    o = torch.cat([o0, hit0["point"][go_on]]).contiguous()
    d = torch.cat([d0, d1[go_on]]).contiguous()
    ts, _, _ = intersect_spheres(o, d, s3.sph_center, s3.sph_radius, T_MIN, BIG)
    return o, d, ts.contiguous()


def margin_rays(b, dev) -> dict:
    """The margin selection's rays on the pose-fit scene (``b``, from
    ``teapot_on_ground``): ``{"camera": (o, d, t_cap), "surface": ...}``,
    the pose fit's camera rays (64x64 at 8 spp) and 4,096 rays leaving
    random points of the teapot's surface in random directions, ``t_cap``
    from the brute-force query (3.4e38 on a miss)."""
    base = b.scene
    w, h, spp = POSE["width"], POSE["height"], POSE["spp"]
    pix = torch.arange(w * h, dtype=torch.int32, device=dev)
    o_cam, d_cam = camera_rays(b.camera, SEED, pix.repeat(spp),
                               torch.arange(spp, dtype=torch.int32,
                                            device=dev).repeat_interleave(w * h), w, h)
    g = torch.Generator(device="cpu").manual_seed(7)
    ti = torch.randint(0, base.n_triangles, (w * h,), generator=g).to(dev)
    w1 = torch.rand((w * h, 1), generator=g).to(dev)
    w2 = torch.rand((w * h, 1), generator=g).to(dev) * (1.0 - w1)
    o_srf = base.tri_a[ti] * (1.0 - w1 - w2) + base.tri_b[ti] * w1 + base.tri_c[ti] * w2
    d_srf = vm.normalize(torch.randn((w * h, 3), generator=g).to(dev))
    out = {}
    for name, (o, d) in (("camera", (o_cam, d_cam)), ("surface", (o_srf, d_srf))):
        hit = trace_closest(base, o, d)
        out[name] = (o.contiguous(), d.contiguous(),
                     torch.where(hit["hit"], hit["t"], BIG).contiguous())
    return out
