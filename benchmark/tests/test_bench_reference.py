"""The reference against the program's CPU path at cut sizes: the same
images and event counts bit for bit, the same losses and gradients."""

from __future__ import annotations

import json

import pytest
import torch

from benchmark.drivers import fit as fit_driver
from benchmark.reference import diff as ref_diff
from benchmark.reference import render as ref_render
from benchmark.reference import scene as ref_scene
from benchmark.tests.conftest import REPO


def _config(name):
    return json.loads((REPO / "benchmark" / "configs" / f"{name}.json").read_text())


@pytest.mark.parametrize("config", ["threeBalls", "teapot"])
def test_reference_render_equals_the_program_on_the_host(config):
    from zraytrace_tpu_torch.config import RenderParams
    from zraytrace_tpu_torch.render import render

    from benchmark.drivers.render import program_scene

    cfg = _config(config)
    desc = cfg["scenes"][cfg["render"]["scene"]]
    w, h, spp, depth, seed = 10, 8, 2, 5, 3_456_789_012
    built = program_scene(desc, "cpu")
    img, st = render(built.scene, built.camera,
                     RenderParams(width=w, height=h, samples_per_pixel=spp, max_depth=depth,
                                  seed=seed), "cpu")
    scene = ref_scene.build(desc, REPO, "cpu")
    vals, counts = ref_render.render_pixels(scene, seed, torch.arange(w * h), w, h, spp, depth)
    assert torch.equal(vals, img.reshape(-1, 3))
    assert counts == dict(rays=st.rays, reflections=st.reflections,
                          background_hits=st.background_hits,
                          recursion_depth_hits=st.recursion_depth_hits, samples=st.samples)


@pytest.mark.parametrize("traffic", ["albedo_fit", "pose_fit"])
def test_reference_loss_and_gradients_equal_the_program_on_the_host(traffic, root):
    from benchmark import run

    cell_name = {"albedo_fit": "threeBalls.albedo_fit", "pose_fit": "teapot.pose_fit"}[traffic]
    cell = run.load_cell(root, cell_name)
    cell.seed, cell.device = 2_999_999_999, "cpu"
    tr = cell.traffic
    desc = cell.config["scenes"][cell.config["fit_scene"]]
    forward, leaves = fit_driver.program_loss(cell, tr, desc, "cpu")
    loss = forward()
    loss.backward()
    loss_fn, ref_leaves = fit_driver.reference_loss(cell, tr, desc, "cpu", torch.float32)
    live = {k: v.clone().requires_grad_(True) for k, v in ref_leaves.items()}
    ref_loss = loss_fn(live)
    ref_loss.backward()
    assert float(ref_loss.detach()) == pytest.approx(float(loss.detach()), rel=1e-6)
    for k, v in leaves.items():
        assert torch.allclose(live[k].grad, v.grad, rtol=1e-4, atol=1e-6 * float(v.grad.abs().max()))


def test_reference_adam_takes_the_steps_of_pytorchs_adam():
    x0 = torch.tensor([1.0, -2.0, 0.5])
    loss_fn = lambda p: ((p["x"] - 3.0) ** 2).sum()
    losses, g1, pts = ref_diff.adam_steps(loss_fn, {"x": x0}, 0.1, 3)
    x = x0.clone().requires_grad_(True)
    opt = torch.optim.Adam([x], lr=0.1)
    for k in range(3):
        assert torch.equal(pts[k]["x"], x.detach())
        opt.zero_grad()
        loss_fn({"x": x}).backward()
        opt.step()
    assert torch.equal(pts[3]["x"], x.detach())
    assert torch.equal(g1["x"], 2.0 * (x0 - 3.0))
    assert losses[0] == pytest.approx(float(((x0 - 3.0) ** 2).sum()))
    # following another side's points: the losses are taken there, the
    # steps move from the first point with the gradients taken there
    other = [{"x": x0 + k} for k in range(3)]
    losses, _, pts = ref_diff.adam_steps(loss_fn, {"x": x0}, 0.1, 3, points=other)
    assert losses == [float(loss_fn(o)) for o in other]
    assert [torch.equal(a["x"], b["x"]) for a, b in zip(pts, other)] == [True] * 3
    y = x0.clone().requires_grad_(True)
    opt = torch.optim.Adam([y], lr=0.1)
    for o in other:
        y.grad = 2.0 * (o["x"] - 3.0)
        opt.step()
    assert torch.equal(pts[3]["x"], y.detach())


def test_reference_adam_starts_from_a_given_state():
    loss_fn = lambda p: ((p["x"] - 3.0) ** 2).sum()
    x = torch.tensor([1.0, -2.0, 0.5], requires_grad=True)
    opt = torch.optim.Adam([x], lr=0.1)
    for _ in range(2):
        opt.zero_grad()
        loss_fn({"x": x}).backward()
        opt.step()
    state = {"x": {s: t.clone() for s, t in opt.state[x].items()}}
    start = x.detach().clone()
    losses, g1, pts = ref_diff.adam_steps(loss_fn, {"x": start}, 0.1, 2, state=state)
    for k in range(2):
        assert torch.equal(pts[k]["x"], x.detach())
        opt.zero_grad()
        loss_fn({"x": x}).backward()
        if k == 0:
            assert torch.equal(g1["x"], x.grad)
        opt.step()
    assert torch.equal(pts[2]["x"], x.detach())
    assert float(state["x"]["step"]) == 2.0  # the given state is not stepped
