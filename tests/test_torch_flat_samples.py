"""``render_diff``'s samples as lanes of one ``trace_paths`` call, on the CPU.

The reference is the per-sample loop written out here: one
``trace_paths`` call per sample, with the sample's REINFORCE baseline (the
detached running mean of the pixel's earlier samples) passed in as
``score_baseline`` and applied inside the trace. ``render_diff`` traces
the samples as lanes of one call and applies the baseline after the
trace. The image must be equal bit for bit, and each leaf's gradient
within 1e-5 of that leaf's largest, since only the order of the sums over
lanes differs. Scene 1 has glass, so ``mat_ior``'s REINFORCE gradient is
live; the teapot pose fit runs the winner pass and the margin selection
on planes.
"""

import pytest
import torch

from zraytrace_tpu_torch import kernel_inputs as ki
from zraytrace_tpu_torch import render_diff as rd
from zraytrace_tpu_torch import vecmath as vm
from zraytrace_tpu_torch.geometry.bvh import build_tri_bvh
from zraytrace_tpu_torch.inverse import DIFF_FIELDS, merge_scene, split_scene
from zraytrace_tpu_torch.ops import flash_intersect as fi
from zraytrace_tpu_torch.profiling import counter, reset
from zraytrace_tpu_torch.scenes import teapot_on_ground, three_balls
from zraytrace_tpu_torch.transforms import Pose, transform_triangles

torch.set_num_threads(1)

SEED = 7
BALLS = dict(width=16, height=16, spp=4, max_depth=4, edge_eps=(0.01, 0.02))
POSE = dict(width=16, height=16, spp=2, max_depth=3, edge_eps=(ki.POSE_EPS, 2 * ki.POSE_EPS),
            edge_occlusion=False, mesh_fast=True)


def per_sample(scene, camera, width, height, spp, max_depth, **kw):
    """``render_diff`` as one ``trace_paths`` call per sample, each with
    its baseline passed in."""
    n = width * height
    pixel_ids = torch.arange(n, dtype=torch.int32)
    total = torch.zeros((n, 3))
    stop_total = torch.zeros_like(total)
    for k in range(spp):
        b = vm.div(stop_total, max(float(k), 1.0))
        sample_ids = torch.full((n,), k, dtype=torch.int32)
        r = rd.trace_paths(scene, camera, pixel_ids, sample_ids, SEED, width, height, max_depth,
                           branch_grad=True, score_baseline=b, **kw)
        total = total + r
        stop_total = stop_total + r.detach()
    return vm.div(total, float(spp)).reshape(height, width, 3)


def flat(scene, camera, width, height, spp, max_depth, **kw):
    return rd.render_diff(scene, camera, width, height, spp, max_depth, seed=SEED, **kw)


@pytest.fixture(scope="module")
def balls():
    return three_balls("cpu")


@pytest.fixture(scope="module")
def teapot():
    b = teapot_on_ground("cpu")
    order = build_tri_bvh(b.scene.tri_a, b.scene.tri_b, b.scene.tri_c).prim_order
    return b, order


def balls_run(balls, render):
    """Scene 1's image and the gradient of a loss on it, every leaf of
    ``DIFF_FIELDS`` requiring grad."""
    params, static = split_scene(balls.scene)
    live = {f: v.detach().clone().requires_grad_(True) for f, v in params.items()}
    img = render(merge_scene(live, static), balls.camera, **BALLS)
    ((img - 0.3) ** 2).mean().backward()
    return img.detach(), {f: live[f].grad for f in DIFF_FIELDS}


def pose_run(teapot, render):
    """The pose fit's image at ``POSE_START`` on planes packed in the BVH
    order, and the offset's gradient."""
    b, order = teapot
    off = torch.tensor(ki.POSE_START, requires_grad=True)
    scene = transform_triangles(b.scene, Pose(off, torch.zeros(3), torch.ones(())))
    with torch.no_grad():
        planes = fi.pack_tri_planes(scene.tri_a.detach(), scene.tri_b.detach(),
                                    scene.tri_c.detach(), order=order)
    img = render(scene, b.camera, tri_flash=planes, **POSE)
    ((img - 0.3) ** 2).mean().backward()
    return img.detach(), {"offset": off.grad}


def assert_same(got, want):
    """Images equal bit for bit; each gradient within 1e-5 of its largest."""
    (img, grads), (img_w, grads_w) = got, want
    assert torch.equal(img, img_w)
    for f, g_w in grads_w.items():
        g = grads[f]
        if g_w is None:
            assert g is None or not bool(g.any()), f
            continue
        scale = float(g_w.abs().max())
        assert bool(torch.isfinite(g).all()), f
        assert float((g - g_w).abs().max()) <= 1e-5 * scale, f


@pytest.fixture(scope="module")
def balls_one_group(balls):
    reset()
    got = balls_run(balls, flat)
    return got, counter("diff.sample_groups")


def test_balls_flat_equals_per_sample(balls, balls_one_group):
    """Scene 1 at 16x16, 4 spp, depth 4, edge factors on, every leaf
    requiring grad: one call of 1,024 lanes against four of 256."""
    got, groups = balls_one_group
    want = balls_run(balls, per_sample)
    assert groups == 1
    assert float(got[1]["mat_ior"].abs().max()) > 0  # the REINFORCE term is live
    assert_same(got, want)


def test_pose_flat_equals_per_sample(teapot):
    """The teapot pose offset at 16x16, 2 spp, depth 3."""
    reset()
    got = pose_run(teapot, flat)
    assert counter("diff.sample_groups") == 1
    want = pose_run(teapot, per_sample)
    assert float(want[1]["offset"].abs().max()) > 0
    assert_same(got, want)


@pytest.mark.parametrize("max_lanes, groups", [(512, 2), (256, 4)])
def test_groups_carry_the_baseline(monkeypatch, balls, balls_one_group, max_lanes, groups):
    """Scene 1 split into 2 and 4 groups gives one group's image and
    gradients: the baseline carries across groups."""
    monkeypatch.setattr(rd, "MAX_FLAT_LANES", max_lanes)
    assert rd.sample_groups(16 * 16, 4) == [4 // groups] * groups
    reset()
    got = balls_run(balls, flat)
    assert counter("diff.sample_groups") == groups
    assert_same(got, balls_one_group[0])


@pytest.mark.parametrize("width, height, spp, want", [
    (128, 128, 8, [8]),  # threeBalls.albedo_fit
    (64, 64, 8, [8]),  # teapot.pose_fit
    (512, 512, 3, [1, 1, 1]),  # 2^18 pixels: one sample a call
    (1000, 1000, 2, [1, 1]),
    (300, 300, 8, [2, 2, 2, 2]),
    (300, 200, 10, [4, 4, 2]),
])
def test_sample_groups(monkeypatch, width, height, spp, want):
    """The groups at the fit cells' sizes and past them, and the lanes of
    each ``trace_paths`` call ``render_diff`` makes (the trace stubbed)."""
    assert rd.sample_groups(width * height, spp) == want
    calls = []

    def trace(scene, camera, pixel_ids, sample_ids, *args, **kw):
        calls.append((pixel_ids.clone(), sample_ids.clone()))
        n = pixel_ids.shape[0]
        return torch.zeros((n, 3)), torch.zeros((n,))

    monkeypatch.setattr(rd, "trace_paths", trace)
    reset()
    img = rd.render_diff(_stub_scene(), None, width, height, spp, 2, sample_start=5)
    assert img.shape == (height, width, 3) and not bool(img.any())
    assert counter("diff.sample_groups") == len(want)
    n, k = width * height, 5
    for (pix, samp), g in zip(calls, want):
        assert torch.equal(pix, torch.arange(n, dtype=torch.int32).repeat(g))
        assert torch.equal(samp.reshape(g, n),
                           torch.arange(k, k + g, dtype=torch.int32)[:, None].expand(g, n))
        k += g


def _stub_scene():
    """Just enough of a scene for ``render_diff``'s own work: a device and
    no triangles."""
    class Stub:
        sph_center = torch.zeros((1, 3))
        tri_a = tri_b = tri_c = torch.zeros((0, 3))
        n_triangles = 0

    return Stub()
