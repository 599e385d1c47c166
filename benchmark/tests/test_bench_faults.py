"""The check fails what it must: the control (the reference in bfloat16
standing in for the program) and each fault a cell can have, planted in
the program underneath a run on the host at cut sizes. (No cell spans
chips, so the exchange between chips has no fault to plant.)"""

from __future__ import annotations

import pytest
import torch

from benchmark import control, run

CELLS = ["threeBalls.render", "teapot.render", "threeBalls.albedo_fit", "teapot.pose_fit"]


def _correct(cell, numbers: dict) -> bool:
    return all(v == v and v <= cell.limits[k] for k, v in numbers.items())


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name, root):
    cell = run.load_cell(root, name)
    faults = ("altered", "half") if name.endswith("fit") else ()
    r = control.readings(cell, 6_000_000_001, 0.1, ["cpu"], faults)
    assert _correct(cell, {k: v for k, v in r["program"].items() if v is not None})
    for stand_in in ("control",) + faults:
        assert not _correct(cell, {k: float("nan") if v is None else v
                                   for k, v in r[stand_in].items()}), stand_in


def _faulty_run(root, name, monkeypatch, plant, when) -> bool:
    """Whether the run comes out correct with ``plant``'s fault in the
    program (not in the reference), during set-up and the window, or
    from the window's start on."""
    cell = run.load_cell(root, name)
    cell.seed, cell.seconds, cell.trace, cell.device = 7_000_000_003, 0.3, False, "cpu"
    mod = run.driver(cell.traffic["kind"])
    with monkeypatch.context() as m:
        if when == "setup_and_window":
            plant(m)
        else:
            loop = mod.closed_loop

            def planted_loop(*a, **k):
                plant(m)
                return loop(*a, **k)

            m.setattr(mod, "closed_loop", planted_loop)
        res = mod.run(cell)
    return _correct(cell, res["check"]())


WHEN = ["setup_and_window", "window_only"]


def _half_samples(m):
    """Half of each pixel's samples traced, the mean taken over them."""
    from zraytrace_tpu_torch import render

    orig = render.trace_lanes

    def half(route, scene, camera, lay, seed, spp, max_depth, sample_start=0):
        sums, counters = orig(route, scene, camera, lay, seed, max(spp // 2, 1), max_depth,
                              sample_start)
        return sums * (spp / max(spp // 2, 1)), counters

    m.setattr(render, "trace_lanes", half)


def _altered_image(m):
    """Every image altered where it is made: traced with another seed
    than the one asked for."""
    from zraytrace_tpu_torch import render

    orig = render.trace_lanes
    m.setattr(render, "trace_lanes", lambda route, scene, camera, lay, seed, *a: orig(
        route, scene, camera, lay, seed ^ 1, *a))


def _over_counted(m):
    """The rays and reflections over-counted by 5% of the rays, the
    counters' identities kept."""
    from zraytrace_tpu_torch import render

    orig = render.trace_lanes

    def counted(*a, **k):
        sums, counters = orig(*a, **k)
        extra = counters[0] // 20
        return sums, counters + extra * torch.tensor([1, 1, 0, 0, 0, 0], dtype=counters.dtype)

    m.setattr(render, "trace_lanes", counted)


@pytest.mark.parametrize("name", ["threeBalls.render", "teapot.render"])
@pytest.mark.parametrize("plant", [_half_samples, _altered_image, _over_counted])
@pytest.mark.parametrize("when", WHEN)
def test_render_faults_are_not_correct(name, plant, when, root, monkeypatch):
    assert not _faulty_run(root, name, monkeypatch, plant, when)


def _frozen_state(m):
    """A step that leaves the parameters unchanged."""
    m.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)


def _half_batch(m):
    """The loss over half of the image's pixels, their mean."""
    from zraytrace_tpu_torch import inverse, kernel_inputs

    half = lambda img, target: ((img - target)[: img.shape[0] // 2] ** 2).mean()
    m.setattr(inverse, "image_loss", half)
    m.setattr(kernel_inputs, "pose_loss", lambda base, camera, order, off, target, **dims: half(
        kernel_inputs.pose_image(base, camera, order, off, kernel_inputs.POSE_EPS, **dims),
        target))


def _altered_loss(m):
    """The loss altered where it is made."""
    from zraytrace_tpu_torch import inverse, kernel_inputs

    orig_image, orig_pose = inverse.image_loss, kernel_inputs.pose_loss
    m.setattr(inverse, "image_loss", lambda img, target: orig_image(img, target) * 1.001)
    m.setattr(kernel_inputs, "pose_loss",
              lambda *a, **k: orig_pose(*a, **k) * 1.001)


@pytest.mark.parametrize("name", ["threeBalls.albedo_fit", "teapot.pose_fit"])
@pytest.mark.parametrize("plant", [_frozen_state, _half_batch, _altered_loss])
@pytest.mark.parametrize("when", WHEN)
def test_fit_faults_are_not_correct(name, plant, when, root, monkeypatch):
    assert not _faulty_run(root, name, monkeypatch, plant, when)
