"""``render.mesh_routing``, the route ``render()``, ``render_checkpointed``
and ``sharded_sums`` share, on the CPU.

The route is decided from the scene's materials before any launch, as
``zraytrace_tpu/render.py:576-593`` decides it: for a CUDA device a
const-material mesh goes to the bounce kernel's mesh mode, a mesh whose
materials read an image texture to the wavefront with the flash winner
(its planes carry no ``attrs`` table). The decision needs no card: the
planes are packed on the scene's device. The textured route's engine is
held to the JAX package's XLA wavefront over the same flash planes, the
route the JAX package gives such a mesh on the TPU.
"""

import jax.numpy as jnp
import numpy as np
import torch

from zraytrace_tpu import camera as jcam
from zraytrace_tpu.geometry.bvh import build_tri_bvh as jax_build_tri_bvh
from zraytrace_tpu.ops.flash_intersect import pack_tri_planes as jax_pack_tri_planes
from zraytrace_tpu.render import wavefront_trace as jax_wavefront
from zraytrace_tpu.scene import SceneBuilder as JaxBuilder
from zraytrace_tpu_torch import RenderParams
from zraytrace_tpu_torch.checkpoint import render_checkpointed
from zraytrace_tpu_torch.convert import camera_from_numpy, scene_from_numpy
from zraytrace_tpu_torch.profiling import counter
from zraytrace_tpu_torch.render import MeshRoute, mesh_routing, render, trace_route

from torch_jax_native import jax_native  # noqa: F401  (an autouse fixture)

torch.set_num_threads(1)

W, H, SPP, DEPTH = 16, 12, 2, 4


def _scene(textured_mesh: bool):
    """A grey ground sphere, a metal sphere and two triangles whose
    material reads an image texture (or is a constant colour)."""
    b = JaxBuilder()
    b.add_sphere((0.0, -100.5, -1.0), 100.0, b.add_lambertian_color((0.5, 0.5, 0.5)))
    b.add_sphere((-0.9, 0.0, -1.2), 0.4, b.add_metal_color((0.8, 0.6, 0.2)))
    if textured_mesh:
        img = (np.arange(4 * 8 * 3).reshape(4, 8, 3) % 7).astype(np.float32) / 6.0
        mat = b.add_lambertian(b.add_image_texture(img))
    else:
        mat = b.add_lambertian_color((0.7, 0.15, 0.1))
    a = np.array([(-0.6, -0.5, -1.0), (0.6, -0.5, -1.0)], np.float32)
    bb = np.array([(0.6, -0.5, -1.0), (0.6, 0.7, -1.1)], np.float32)
    c = np.array([(0.0, 0.8, -1.0), (-0.6, -0.5, -1.0)], np.float32)
    b.add_triangles(a, bb, c, mat)
    js = b.build()
    jc = jcam.make_camera((0, 0.2, 1.0), (0, 0, -1), (0, 1, 0), 60.0, W / H)
    scene = scene_from_numpy({k: np.asarray(v) for k, v in js._asdict().items()}, "cpu")
    return js, jc, scene, camera_from_numpy(*map(np.asarray, jc), device="cpu")


def test_routes_by_material():
    _, _, textured, _ = _scene(True)
    _, _, const, _ = _scene(False)
    route = mesh_routing(textured, "cuda")
    assert not route.kernel and route.tri_flash is not None and route.tri_flash.attrs is None
    route = mesh_routing(const, "cuda")
    assert route.kernel and route.tri_flash.attrs is not None
    for scene in (textured, const):  # the CPU: the plain wavefront, brute force
        assert mesh_routing(scene, "cpu") == MeshRoute(True, None)
    spheres = const._replace(**{k: getattr(const, k)[:0]
                                for k in ("tri_a", "tri_b", "tri_c", "tri_mat")})
    assert mesh_routing(spheres, "cuda") == MeshRoute(True, None)


def test_textured_route_matches_jax_flash_wavefront():
    """The route a textured mesh takes on the card, run on the CPU (the
    plain flash winner): counters equal JAX's XLA wavefront over JAX's
    flash planes of the same mesh, images within the texel-flip bar; no
    kernel launched."""
    js, jc, scene, camera = _scene(True)
    route = mesh_routing(scene, "cuda")
    n = W * H
    before = (counter("launch.bounce"), counter("launch.flash"))
    sums, counters = trace_route(route, scene, camera, torch.arange(n, dtype=torch.int32), 42,
                                 W, H, SPP, DEPTH, 0, n, n, 1)
    assert (counter("launch.bounce"), counter("launch.flash")) == before
    order = jax_build_tri_bvh(js.tri_a, js.tri_b, js.tri_c).prim_order
    tf = jax_pack_tri_planes(js.tri_a, js.tri_b, js.tri_c, order=order, tri_mat=js.tri_mat,
                             const_materials=False)
    assert tf.attrs is None
    sx, cx = jax_wavefront(js, jc, jnp.arange(n, dtype=jnp.int32), 42, W, H, SPP, DEPTH, 0,
                           None, n, n, 1, tri_flash=tf)
    assert counters.tolist() == [int(hi) * (1 << 32) + int(lo) for hi, lo in np.asarray(cx)]
    assert counters[1] > 0 and counters[4] == n * SPP
    diff = np.abs(np.asarray(sx) - sums.numpy())
    assert (diff > 1e-4).mean() < 0.05 and np.median(diff) < 1e-5


def test_entry_points_share_the_route(tmp_path):
    """On the CPU, ``render()`` and ``render_checkpointed`` trace the
    textured scene through the same route: equal counters, and images
    within the checkpoint's reordered-sum bar."""
    _, _, scene, camera = _scene(True)
    params = RenderParams(W, H, SPP, DEPTH)
    img, st = render(scene, camera, params, "cpu")
    img_c, st_c = render_checkpointed(scene, camera, params, tmp_path / "ck.npz", chunk_spp=1,
                                      device="cpu")
    keys = ("rays", "reflections", "background_hits", "recursion_depth_hits", "samples")
    assert [getattr(st, k) for k in keys] == [getattr(st_c, k) for k in keys]
    np.testing.assert_allclose(img_c.numpy(), img.numpy(), rtol=2e-5, atol=2e-6)
