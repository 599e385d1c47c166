"""The port's camera against the JAX package's, on the CPU.

``make_camera`` builds its frame on the host with torch operations, so a
``look_from`` or ``vfov`` that requires grad keeps its graph, as the JAX
function (plain ``jnp``) does. For inputs that need no grad, the frame is
bit-equal to the numpy-built frame of the port before it carried
autograd. Gradients through ``render_diff`` with edge factors are held to
tests/test_diff_mesh.py's bar, ``atol = 5e-4 max|g|``, ``rtol = 2e-3``.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zraytrace_tpu import scene as jsc
from zraytrace_tpu.camera import make_camera as jax_make_camera
from zraytrace_tpu.render_diff import render_diff as jax_render_diff
from zraytrace_tpu_torch import vecmath as vm
from zraytrace_tpu_torch.camera import Camera, make_camera
from zraytrace_tpu_torch.convert import scene_from_numpy
from zraytrace_tpu_torch.render_diff import render_diff

torch.set_num_threads(1)

GRAD_ATOL, GRAD_RTOL = 5e-4, 2e-3  # tests/test_diff_mesh.py:104-106
W = H = 16
SPP, DEPTH = 4, 3
EDGE_EPS = (0.01, 0.02)
LOOK_AT, VUP = (0.0, 0.0, 1.0), (0.0, 1.0, 0.0)
LOOK_FROM = (0.0, 0.0, -2.0)
SHIFT = (0.2, -0.15, 0.0)  # tools/grad_report.py TARGET_SHIFT["camera_pose"]


def _numpy_frame(look_from, look_at, vup, vfov_degrees, aspect_ratio) -> Camera:
    """The frame as the port built it before it carried autograd: inputs
    through numpy to f32, the angle rounded once from f64."""
    f32 = lambda v: torch.as_tensor(np.asarray(v, np.float32))  # noqa: E731
    look_from, look_at, vup = f32(look_from), f32(look_at), f32(vup)
    h = torch.tan(f32(math.pi * vfov_degrees / 180.0) / 2.0)
    viewport_height = 2.0 * h
    viewport_width = aspect_ratio * viewport_height
    w = vm.normalize(look_from - look_at)
    u = vm.normalize(torch.linalg.cross(vup, w))
    v = torch.linalg.cross(w, u)
    horizontal = u * viewport_width
    vertical = v * viewport_height
    return Camera(look_from, look_from - horizontal * 0.5 - vertical * 0.5 - w, horizontal,
                  vertical)


@pytest.mark.parametrize("case", [
    ((0.0, 0.0, -7.0), (0.0, 0.0, 1.0), (0.0, 1.0, 0.0), 45.0, 1.0),
    ((-8.0, 0.0, -10.0), (0.0, 0.0, 1.0), (0.0, 1.0, 0.0), 45.0, 1.0),
    ((0.0, 3.0, -9.0), (0.0, 1.0, 5.0), (0.0, 1.0, 0.0), 50.0, 1.0),
    ((0.4, 0.3, -5.0), (0.0, 0.0, 1.0), (0.0, 1.0, 0.0), 41.3, 4.0 / 3.0),
])
def test_frame_without_grad_is_bit_equal(case):
    """Lists, numpy arrays and tensors that need no grad all give the
    numpy-built frame bit for bit."""
    want = _numpy_frame(*case)
    lf, la, vup, vfov, aspect = case
    for args in ((lf, la, vup), tuple(np.asarray(x, np.float32) for x in (lf, la, vup)),
                 tuple(torch.tensor(x) for x in (lf, la, vup))):
        got = make_camera(*args, vfov, aspect, device="cpu")
        for g, w in zip(got, want):
            assert g.dtype == torch.float32 and not g.requires_grad
            assert torch.equal(g, w)


def _sphere_scene():
    """tools/grad_report.py's sphere probe: a red Lambertian sphere."""
    b = jsc.SceneBuilder()
    b.add_sphere((0.45, 0.3, 5.0), 1.0, b.add_lambertian_color((0.8, 0.1, 0.1)))
    js = b.build()
    return js, scene_from_numpy({k: np.asarray(v) for k, v in js._asdict().items()}, "cpu")


@pytest.fixture(scope="module")
def pose_grads():
    """d loss / d look_from through each package's make_camera and
    render_diff with edge factors, the target rendered at a shifted
    pose with another seed."""
    js, scene = _sphere_scene()
    lf = np.asarray(LOOK_FROM, np.float32)
    lf_t = lf + np.asarray(SHIFT, np.float32)

    def jimage(look_from, eps, seed):
        cam = jax_make_camera(look_from, LOOK_AT, VUP, 45.0, 1.0)
        return jax_render_diff(js, cam, W, H, SPP, DEPTH, seed=seed, edge_eps=eps)

    jtarget = jimage(jnp.asarray(lf_t), None, 9)
    jloss = lambda x: jnp.mean((jimage(x, EDGE_EPS, 42) - jtarget) ** 2)  # noqa: E731
    want_loss, want = jax.value_and_grad(jloss)(jnp.asarray(lf))

    def image(look_from, eps, seed):
        cam = make_camera(look_from, LOOK_AT, VUP, 45.0, 1.0, device="cpu")
        return render_diff(scene, cam, W, H, SPP, DEPTH, seed=seed, edge_eps=eps)

    target = image(torch.from_numpy(lf_t), None, 9).detach()
    x = torch.from_numpy(lf.copy()).requires_grad_(True)
    loss = ((image(x, EDGE_EPS, 42) - target) ** 2).mean()
    loss.backward()
    return dict(target=target.numpy(), jtarget=np.asarray(jtarget), loss=float(loss.detach()),
                jloss=float(want_loss), grad=x.grad.numpy(), jgrad=np.asarray(want))


def test_target_image_matches_jax(pose_grads):
    np.testing.assert_allclose(pose_grads["target"], pose_grads["jtarget"], rtol=0, atol=2e-5)


def test_look_from_gradient_matches_jax(pose_grads):
    """The camera_pose class of tools/grad_report.py, cut to 16x16x4 d3."""
    g, want = pose_grads["grad"], pose_grads["jgrad"]
    np.testing.assert_allclose(pose_grads["loss"], pose_grads["jloss"], rtol=1e-5)
    scale = np.abs(want).max()
    assert scale > 0 and np.isfinite(g).all()
    np.testing.assert_allclose(g, want, atol=GRAD_ATOL * scale, rtol=GRAD_RTOL)


def test_vfov_as_a_tensor():
    """A tensor ``vfov`` goes through ``torch.tan``: as a number it gives
    the same frame within an ulp, and its gradient through the viewport
    matches ``jax.grad`` of the JAX frame."""
    lf = (0.4, 0.3, -5.0)
    vfov = torch.tensor(45.0, requires_grad=True)
    cam = make_camera(lf, LOOK_AT, VUP, vfov, 1.0, device="cpu")
    ref = make_camera(lf, LOOK_AT, VUP, 45.0, 1.0, device="cpu")
    for g, w in zip(cam, ref):
        np.testing.assert_allclose(g.detach().numpy(), w.numpy(), rtol=1e-6, atol=1e-7)
    weights = torch.arange(12, dtype=torch.float32).reshape(4, 3) / 10.0
    (torch.stack(list(cam)) * weights).sum().backward()

    def jsum(v):
        return (jnp.stack(list(jax_make_camera(jnp.asarray(lf, jnp.float32), LOOK_AT, VUP, v,
                                               1.0))) * jnp.asarray(weights.numpy())).sum()

    want = float(jax.grad(jsum)(jnp.float32(45.0)))
    assert want != 0.0
    np.testing.assert_allclose(float(vfov.grad), want, rtol=1e-5)


def test_frame_moves_to_the_device_of_the_caller_with_its_graph():
    """``device`` is applied after the host computation (``Tensor.to`` is
    differentiable): every field of the frame carries the graph of a
    look_from that requires grad."""
    x = torch.tensor(LOOK_FROM, requires_grad=True)
    cam = make_camera(x, LOOK_AT, VUP, 45.0, 1.0, device="cpu")
    assert all(t.requires_grad for t in cam)
    cam.lower_left.sum().backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()
