"""Traffic of ``kind`` ``fit``: Adam steps of an inverse-rendering fit,
back to back.

The benchmark builds the step itself from the program's entries, so that
a traced run can synchronise between the loss and the backward pass:
``loss`` ``image_to_black`` is ``inverse.make_loss_fn`` toward a black
image over the scene leaves ``leaves`` (the rest frozen, ``inverse.
split_scene``), rendered with the run's seed; ``pose_to_offset_zero`` is
``kernel_inputs.pose_loss`` toward ``kernel_inputs.pose_image`` at offset
0, from a start offset drawn from the seed at ``start_distance``.

Set-up builds one step object, optimizer state included, and takes its
first step from the seed's start (the start); the window then takes
more steps on the same object, and keeps the parameters, Adam's state,
loss and gradient of its last ``checked_steps`` steps. The check holds
both to the reference: the start from the reference's own start and a
fresh Adam, the window's last steps with the reference following the
program's parameters from the program's Adam state (``reference.diff.
adam_steps``). Each step sees the parameters the step before left, and
the render seed stays the fit's own, as ``inverse.fit`` keeps it.
"""

from __future__ import annotations

import collections
import gc
import math
import statistics
import sys
import time

import numpy as np
import torch

from benchmark import devtrace
from benchmark.drivers import closed_loop, sync
from benchmark.drivers.render import program_scene
from benchmark.reference import diff as ref_diff
from benchmark.reference import scene as ref_scene

BETAS = (0.9, 0.999)


def start_offset(seed: int, distance: float) -> torch.Tensor:
    """A float32 offset ``distance`` from 0 in a direction drawn from
    ``seed``."""
    v = np.random.default_rng([seed % 2**64, 3]).standard_normal(3)
    return torch.as_tensor((distance * v / np.linalg.norm(v)).astype(np.float32))


def render_seed(seed: int) -> int:
    return seed & 0xFFFFFFFF


def program_loss(cell, tr: dict, desc: dict, dev):
    """``(forward, leaves)``: the program's loss of the fit's leaves (name
    to leaf tensor, each requiring grad)."""
    built = program_scene(desc, dev)
    dims = dict(width=tr["size"], height=tr["size"], spp=tr["spp"], depth=tr["depth"])
    if tr["loss"] == "image_to_black":
        from zraytrace_tpu_torch.inverse import make_loss_fn, split_scene

        params, static = split_scene(built.scene)
        live = {f: params[f].detach().clone().requires_grad_(True) for f in tr["leaves"]}
        frozen = {**static, **{f: v for f, v in params.items() if f not in live}}
        target = torch.zeros((tr["size"], tr["size"], 3), dtype=torch.float32, device=dev)
        loss_fn = make_loss_fn(frozen, built.camera, target, tr["size"], tr["size"], tr["spp"],
                               tr["depth"], render_seed(cell.seed), edge_eps=tuple(tr["edge_eps"]))
        return (lambda: loss_fn(live)), live
    if tr["loss"] == "pose_to_offset_zero":
        from zraytrace_tpu_torch import kernel_inputs as ki
        from zraytrace_tpu_torch.geometry.bvh import build_tri_bvh

        base, camera = built.scene, built.camera
        order = build_tri_bvh(base.tri_a, base.tri_b, base.tri_c).prim_order.to(dev)
        with torch.no_grad():
            target = ki.pose_image(base, camera, order, torch.zeros(3, device=dev), ki.POSE_EPS,
                                   **dims)
        off = start_offset(cell.seed, tr["start_distance"]).to(dev).requires_grad_(True)
        return (lambda: ki.pose_loss(base, camera, order, off, target, **dims)), {"offset": off}
    raise ValueError(f"unknown fit loss {tr['loss']!r}")


# faults a stand-in for the program can carry (``benchmark.control``)
FAULTS = {
    "altered": lambda err, img: (err ** 2).mean() * 1.001,  # the loss altered where made
    "half": lambda err, img: (err[: img.shape[0] // 2] ** 2).mean(),  # half of the batch
}


def reference_loss(cell, tr: dict, desc: dict, dev, dtype, fault: str | None = None):
    """``(loss_fn, leaves)`` of the reference, as ``program_loss``'s; with
    ``fault`` one of ``FAULTS`` planted in the loss."""
    scene = ref_scene.build(desc, cell.root, dev, dtype)
    img = lambda s: ref_diff.image(s, render_seed(tr.get("render_seed", cell.seed)), tr["size"],
                                   tr["size"], tr["spp"], tr["depth"], tuple(tr["edge_eps"]),
                                   tr["edge_occlusion"])
    mse = FAULTS.get(fault, lambda err, im: (err ** 2).mean())
    if tr["loss"] == "image_to_black":
        def black(p):
            im = img(scene._replace(**p))
            return mse(im, im)

        return black, {f: getattr(scene, f) for f in tr["leaves"]}
    moved = lambda off: scene._replace(tri_a=scene.tri_a + off, tri_b=scene.tri_b + off,
                                       tri_c=scene.tri_c + off)
    with torch.no_grad():
        target = img(moved(torch.zeros(3, dtype=dtype, device=dev)))
    off = start_offset(cell.seed, tr["start_distance"]).to(device=dev, dtype=dtype)

    def pose(p):
        im = img(moved(p["offset"]))
        return mse(im - target, im)

    return pose, {"offset": off}


def run(cell) -> dict:
    dev = cell.device
    tr = cell.traffic
    desc = cell.config["scenes"][cell.config["fit_scene"]]
    forward, leaves = program_loss(cell, tr, desc, dev)
    opt = torch.optim.Adam(list(leaves.values()), lr=tr["lr"], betas=BETAS, eps=1e-8)
    timed = cell.trace

    def step(_=None):
        t0 = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        loss = forward()
        if timed:
            sync(dev)
        t1 = time.perf_counter()
        loss.backward()
        opt.step()
        if timed:
            sync(dev)
        return loss.detach(), t1 - t0, time.perf_counter() - t1

    def point():
        return {k: v.detach().clone() for k, v in leaves.items()}

    def kept_step():
        """A step, with the parameters and Adam's state before it, and its
        loss and gradient as Adam's update read it (``.grad``: Adam
        without weight decay leaves it as it is)."""
        before = dict(point=point(), state={
            k: {s: t.clone() for s, t in opt.state[v].items()}
            for k, v in leaves.items() if opt.state.get(v)})
        out = step()
        grad = {k: torch.zeros_like(v) if v.grad is None else v.grad.detach().clone()
                for k, v in leaves.items()}
        return out, dict(before, loss=out[0], grad=grad)

    _, start = kept_step()
    start_end = point()
    sync(dev)
    setup_end = time.perf_counter()

    kept = collections.deque(maxlen=tr["checked_steps"])

    def window_step(_):
        out, k = kept_step()
        kept.append(k)
        return out

    steps, window_s = closed_loop(window_step, cell.seconds, dev)
    print("# step seconds on the host: " + " ".join(f"{s[1] + s[2]:.4f}" for s in steps),
          file=sys.stderr)
    losses = [float(s[0]) for s in steps]
    finite = [math.isfinite(x) for x in losses]
    res = dict(setup_end=setup_end, window_s=window_s, attempted=len(steps),
               failed=sum(not f for f in finite),
               metrics=dict(fit_step_s=window_s / len(steps)))
    prog = [segment([start], start_end), segment(list(kept), point())]
    if timed:
        res["forward_s"] = statistics.fmean(s[1] for s in steps)
        res["backward_s"] = statistics.fmean(s[2] for s in steps)
        _, res["profile"] = devtrace.profiled(step, tr["profile_steps"], dev)
        res["profiled_steps"] = tr["profile_steps"]

    def check(stand_in=None):
        """The check's numbers, the program's state freed first; with
        ``stand_in`` (a dtype, or one of ``FAULTS``), the reference in
        that dtype or with that fault stands in for the program (the
        control, a planted fault), from the same start and the same
        window points and Adam state the program's checked steps began
        at."""
        nonlocal forward, leaves, opt
        forward = leaves = opt = None
        gc.collect()
        if torch.device(dev).type == "cuda":
            torch.cuda.empty_cache()
        side = prog
        if stand_in is not None:
            fault = stand_in if stand_in in FAULTS else None
            dtype = torch.float32 if fault else stand_in
            side = [reference_steps(cell, tr, desc, dev, dtype, seg, follow=False, fault=fault)
                    for seg in prog]
        ref = [reference_steps(cell, tr, desc, dev, torch.float32, seg, follow=k > 0)
               for k, seg in enumerate(side)]
        per = [numbers(s, r) for s, r in zip(side, ref)]
        return {k: max(p[k] for p in per) for k in per[0]}

    res["check"] = check
    return res


def segment(kept: list, end: dict) -> dict:
    """A run of consecutive kept steps: the losses, the first step's
    gradient, the parameters before each step and after the last, and
    Adam's state before the first."""
    return dict(losses=[float(k["loss"]) for k in kept], g1=kept[0]["grad"],
                points=[k["point"] for k in kept] + [end], state=kept[0]["state"])


def reference_steps(cell, tr, desc, dev, dtype, seg: dict, follow: bool, fault=None) -> dict:
    """The reference's steps in ``dtype`` over ``seg``'s steps, from
    ``seg``'s Adam state: the start (``seg`` with no state) from the
    reference's own start; a window's steps from ``seg``'s first point,
    and with ``follow`` through each of ``seg``'s points
    (``reference.diff.adam_steps``)."""
    loss_fn, leaves = reference_loss(cell, tr, desc, dev, dtype, fault)
    pts = [{k: v.to(device=dev, dtype=dtype) for k, v in pt.items()} for pt in seg["points"]]
    own = not seg["state"]
    losses, g1, seen = ref_diff.adam_steps(
        loss_fn, leaves if own else pts[0], tr["lr"], len(seg["losses"]), BETAS,
        points=pts if follow else None, state=seg["state"])
    return dict(losses=losses, g1=g1, points=seen, state=seg["state"])


def numbers(side: dict, ref: dict) -> dict:
    """``loss_gap``: the largest relative difference of a step's loss, each
    taken at the same parameters (the reference follows ``side``'s);
    ``grad_gap``: over the leaves, the largest difference of the first
    gradient's norm from the reference's, over the larger of the
    reference's norm of that leaf and of the median leaf; ``step_gap``:
    the same of the change the steps made, over the leaves whose
    reference gradient is at least a thousandth of the median leaf's (the
    others move by round-off alone)."""
    nrm = lambda t: float(t.double().norm())
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(side["losses"], ref["losses"]))
    g_ref = {k: nrm(v) for k, v in ref["g1"].items()}
    g_med = statistics.median(g_ref.values())
    grad_gap = max(abs(nrm(side["g1"][k]) - g_ref[k]) / max(g_ref[k], g_med) for k in g_ref)
    moved = [k for k in g_ref if g_ref[k] >= 1e-3 * g_med]
    change = lambda pts, k: nrm(pts[-1][k].double() - pts[0][k].double())
    d_ref = {k: change(ref["points"], k) for k in moved}
    d_med = statistics.median(d_ref.values())
    step_gap = max(abs(change(side["points"], k) - d_ref[k]) / max(d_ref[k], d_med)
                   for k in moved)
    return dict(loss_gap=loss_gap, grad_gap=grad_gap, step_gap=step_gap)
