"""The port's three examples (``zraytrace_tpu_torch/examples/``) on the
CPU at a cut size: each ``main`` returns, its losses are finite, and its
target image equals the JAX example's target (``render_diff`` of the
same scene) within tests/test_torch_diff.py's image bar, ``atol = 2e-5``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zraytrace_tpu import scene as jsc
from zraytrace_tpu.camera import make_camera as jax_make_camera
from zraytrace_tpu.geometry.bvh import build_tri_bvh as jax_build_tri_bvh
from zraytrace_tpu.ops.flash_intersect import pack_tri_planes as jax_pack_tri_planes
from zraytrace_tpu.render_diff import render_diff as jax_render_diff
from zraytrace_tpu.scenes import build_scene as jax_build_scene
from zraytrace_tpu_torch.examples import camera_calibration, inverse_rendering, mesh_fit

from torch_jax_native import jax_native  # noqa: F401  (an autouse fixture)

torch.set_num_threads(1)

IMAGE_ATOL = 2e-5  # tests/test_torch_diff.py, render_diff's forward against JAX
SIZE = 8
ARGV = ["--cpu", "--steps", "3", "--size", str(SIZE)]


def _check(example, argv, want_target):
    out = example.run(argv)
    assert len(out["losses"]) == 3 and np.isfinite(out["losses"]).all()
    assert out["device"] == "cpu" and out["seconds"] > 0
    np.testing.assert_allclose(out["target"].numpy(), np.asarray(want_target), rtol=0,
                               atol=IMAGE_ATOL)
    assert example.main(argv) == (0 if out["ok"] else 1)
    return out


def test_inverse_rendering():
    b = jsc.SceneBuilder()
    red = b.add_lambertian_color((0.8, 0.2, 0.1))
    green = b.add_lambertian_color(jsc.COLOR_GREEN)
    b.add_sphere((0.0, 0.0, 3.0), 1.2, red)
    b.add_sphere((1.0, -52.0, 4.0), 50.0, green)
    camera = jax_make_camera((0, 0, -5.0), (0, 0, 1.0), (0, 1.0, 0), 45.0, 1.0)
    want = jax_render_diff(b.build(), camera, SIZE, SIZE, 8, 4, seed=5)
    out = _check(inverse_rendering, ARGV, want)
    assert 0.5 < out["radius"] < 1.2  # moved from the perturbed 0.9 toward 1.2, not past


@pytest.mark.parametrize("free_vfov", [False, True])
def test_camera_calibration(free_vfov):
    b = jsc.SceneBuilder()
    red = b.add_lambertian_color((0.8, 0.2, 0.1))
    blue = b.add_lambertian_color((0.15, 0.3, 0.75))
    silver = b.add_metal_color(jsc.COLOR_SILVER)
    green = b.add_lambertian_color(jsc.COLOR_GREEN)
    b.add_sphere((-1.1, 0.0, 3.0), 0.9, red)
    b.add_sphere((1.2, -0.2, 4.0), 0.7, blue)
    b.add_sphere((0.1, 0.5, 6.0), 1.0, silver)
    b.add_sphere((0.0, -51.0, 4.0), 50.0, green)
    camera = jax_make_camera(jnp.asarray((0.4, 0.3, -5.0), jnp.float32),
                             jnp.asarray((0.0, 0.0, 1.0), jnp.float32), (0.0, 1.0, 0.0),
                             jnp.float32(45.0), 1.0)
    want = jax_render_diff(b.build(), camera, SIZE, SIZE, 8, 4, seed=7)
    out = _check(camera_calibration, ARGV + (["--free-vfov"] if free_vfov else []), want)
    assert (out["vfov"] != 45.0) == free_vfov  # vfov moves only when it is free


def test_mesh_fit():
    """The teapot pose fit, cut to 8x8 at 2 spp, depth 2; the JAX target
    is the example's image at offset 0 through JAX's flash planes."""
    jb = jax_build_scene(3)  # for its teapot triangles; the pose scene is built below
    a, bb, c = (np.asarray(x) for x in (jb.scene.tri_a, jb.scene.tri_b, jb.scene.tri_c))
    b = jsc.SceneBuilder()
    b.add_sphere((0.0, -102.33, 7.0), 100.0, b.add_lambertian_color(jsc.COLOR_GREEN))
    b.add_triangles(a, bb, c, b.add_lambertian_color((0.7, 0.15, 0.1)))
    base = b.build()
    camera = jax_make_camera((0.0, 3.0, -9.0), (0.0, 1.0, 5.0), (0.0, 1.0, 0.0), 50.0, 1.0)
    order = jax_build_tri_bvh(base.tri_a, base.tri_b, base.tri_c).prim_order
    tf = jax_pack_tri_planes(base.tri_a, base.tri_b, base.tri_c, order=order)
    want = jax_render_diff(base, camera, SIZE, SIZE, 2, 2, mesh_fast=True, tri_flash=tf,
                           edge_eps=(0.015, 0.03), edge_occlusion="camera")
    out = _check(mesh_fit, ARGV + ["--spp", "2", "--depth", "2"], want)
    assert len(out["errors"]) == 3 and out["n_triangles"] == 6320
    assert out["error_start"] == pytest.approx(float(np.linalg.norm([0.25, -0.175, 0.225])))


def test_mesh_fit_goat_scene():
    """``--goat``: goat_class's 158,000 triangles and camera in the
    example's red material, as the JAX example builds its grid."""
    base, camera = mesh_fit.pose_scene(goat=True, device="cpu")
    assert base.n_triangles == 158000 and base.n_spheres == 1
    np.testing.assert_allclose(base.tex_color[1].numpy(), (0.7, 0.15, 0.1), rtol=1e-6)
    assert torch.equal(camera.origin, torch.tensor((0.0, 8.0, -30.0)))
