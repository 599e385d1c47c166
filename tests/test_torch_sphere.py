"""The bounce kernel's sphere mode, what the host holds of it, on the CPU.

The kernel (``csrc/bounce_kernel.cu``) runs one segment loop per thread
and reads each sphere test's c.c - r^2 from rows it makes once per block.
The card holds the kernel to the plain wavefront bit for bit
(``tests/test_torch_gpu.py``); here:

- ``sphere_rows``, the rows' plain twin, against numpy's float32 on every
  sphere of scenes 0-4 (scene 1's bubble has a negative radius), bit for
  bit;
- the SIMT model (``probes/simt_model.py``) against the plain wavefront:
  its per-path steps sum to rays plus recursion-depth hits, and its
  busiest lane is the wavefront's iteration count, exactly; its warp
  iterations against a count by hand;
- ``bk.simt`` and the bound's price of a sphere test.
"""

import numpy as np
import pytest
import torch

from zraytrace_tpu_torch.ops import bounce_kernel as bk
from zraytrace_tpu_torch.probes import bounds
from zraytrace_tpu_torch.probes import simt_model as sm
from zraytrace_tpu_torch.render import wavefront_trace
from zraytrace_tpu_torch.scenes import build_scene

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def scene1():
    return build_scene(1, "cpu")


@pytest.mark.parametrize("index", [0, 1, 2, 3, 4])
def test_sphere_rows_match_numpy_float32(index):
    b = build_scene(index, "cpu")
    spheres, _, _ = bk.scene_tables(b.scene, b.camera)
    rows = bk.sphere_rows(spheres).numpy()
    s = spheres.numpy().astype(np.float32)
    cx, cy, cz, r = s[:, 0], s[:, 1], s[:, 2], s[:, 3]
    want = ((cx * cx + cy * cy) + cz * cz) - r * r
    assert rows.dtype == np.float32 and rows.shape == (s.shape[0], 4)
    np.testing.assert_array_equal(rows[:, :3], s[:, :3])
    np.testing.assert_array_equal(rows[:, 3].view(np.int32), want.view(np.int32))
    if index == 1:
        assert (r < 0).any(), "scene 1's bubble has a negative radius"


@pytest.mark.parametrize("w,h,spp,sample_start,n_lanes", [
    (20, 13, 3, 0, 64),  # several strided slots, a ragged last one
    (16, 9, 2, 5, 144),  # one slot per lane, a sample offset
])
def test_simt_model_steps_match_the_plain_wavefront(scene1, w, h, spp, sample_start, n_lanes):
    """The model's paths are the wavefront's: their steps sum to rays +
    recursion-depth hits, and the busiest lane's steps are its iterations."""
    depth = 30
    steps = sm.path_steps(scene1.scene, scene1.camera, torch.arange(w * h), w, h, spp, depth,
                          sample_start=sample_start).numpy()
    slots = -(-(w * h) // n_lanes)
    _, c = wavefront_trace(scene1.scene, scene1.camera, torch.arange(n_lanes, dtype=torch.int32),
                           sm.SEED, w, h, spp, depth, sample_start, n_lanes, w * h, slots)
    rays, _, _, rec, samples, iters = c.tolist()
    assert samples == steps.size
    assert int(steps.sum()) == rays + rec
    grid = np.zeros((slots * n_lanes, spp), np.int64)
    grid[:w * h] = steps
    assert int(grid.reshape(slots, n_lanes, spp).sum(axis=(0, 2)).max()) == iters
    fig = sm.simt_figures(steps, n_lanes)
    assert fig["lane_steps"] == rays + rec
    assert 0 < fig["nested"] <= fig["segment"] <= 1


def test_simt_figures_count_warp_iterations_by_hand():
    """Two warps, one of them ragged, two slots: the counts by loops."""
    rng = np.random.default_rng(0)
    n_lanes, slots, spp = 40, 2, 3
    steps = rng.integers(1, 12, size=(n_lanes * slots - 7, spp))
    fig = sm.simt_figures(steps, n_lanes)
    step = {}
    for p in range(steps.shape[0]):
        step[p % n_lanes, p // n_lanes] = steps[p]
    nested = segment = 0
    for warp in range(2):
        lanes = range(32 * warp, min(32 * warp + 32, n_lanes))
        for k in range(slots):
            for s in range(spp):
                nested += max(step[i, k][s] if (i, k) in step else 0 for i in lanes)
        segment += max(sum(step[i, k].sum() for k in range(slots) if (i, k) in step)
                       for i in lanes)
    assert fig["n_warps"] == 2
    assert (fig["nested_iters"], fig["segment_iters"]) == (nested, segment)
    assert fig["lane_steps"] == int(steps.sum())
    assert fig["segment"] == steps.sum() / (32 * segment)


def test_expected_segment_model_is_one_for_a_flat_image():
    steps = np.full((64 * 8, 4), 3)
    assert sm.expected_segment(steps, 64, 8, 1000)["segment"] == 1.0


def test_simt_reads_the_counting_launch():
    work = dict(zip(bk.WORK_FIELDS, range(len(bk.WORK_FIELDS))))
    work.update(lane_steps=96, warp_iters=4, warp_branches=10, nodes=48, warp_nodes=3)
    got = bk.simt(work, [90, 50, 40, 6, 46, 7])
    assert got["identity"] and got["efficiency"] == 96 / 128
    assert got["branches_per_iter"] == 2.5 and got["walk_efficiency"] == 0.5
    work.update(nodes=0, warp_nodes=0)
    assert bk.simt(work, [90, 50, 40, 6, 46, 7])["walk_efficiency"] is None
    assert not bk.simt(work, [90, 50, 40, 5, 45, 7])["identity"]


def test_bound_prices_a_sphere_test_at_16_and_its_row_once():
    w = dict(disc=0, tri_hits=0)
    one = bounds.bounce_flops([1, 0, 1, 0, 1, 1], 7, w, mesh=False)
    two = bounds.bounce_flops([2, 0, 2, 0, 2, 2], 7, w, mesh=False)
    per_ray = bounds.CAMERA_FLOPS + bounds.SEGMENT_FLOPS + 7 * 16 + bounds.MISS_FLOPS
    assert two - one == per_ray
    assert one == per_ray + 7 * bounds.SPHERE_ROW_FLOPS
    assert bounds.SPHERE_TEST_FLOPS + bounds.SPHERE_ROW_FLOPS == 23
