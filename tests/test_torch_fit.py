"""The port's ``inverse.fit`` and ``fd_gradients`` against the JAX
package's, on the CPU, from the same parameters (``params_from_numpy``).

The fit runs the bilinear, image-textured sphere path with edge factors
and a coarse-to-fine bandwidth schedule on the fields of
``tools/diff_bench.py``'s sphere-albedo fit, so every stage of a step is
compared: the loss, the gradient through ``render_diff`` and optax's Adam
formula. (The atlas's gradient is compared in tests/test_torch_diff.py:
in a fit, Adam's first step moves a texel of gradient near its ``eps``
(1e-8) by an amount that no gradient tolerance bounds.)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_grad import _simple_scene
from test_torch_diff import GRAD_ATOL, GRAD_RTOL, _cross, _t, _textured_scene
from zraytrace_tpu.inverse import fd_gradients as jax_fd_gradients
from zraytrace_tpu.inverse import fit as jax_fit
from zraytrace_tpu.inverse import make_loss_fn as jax_make_loss_fn
from zraytrace_tpu.inverse import merge_scene as jmerge
from zraytrace_tpu.inverse import split_scene as jsplit
from zraytrace_tpu.render_diff import render_diff as jax_render_diff
from zraytrace_tpu_torch.convert import params_from_numpy
from zraytrace_tpu_torch.inverse import fd_gradients, fit, make_loss_fn, merge_scene, split_scene

torch.set_num_threads(1)

W = H = 8
SPP, DEPTH = 2, 3
STEPS = 3
LR = 2e-2
FD_EPS = 2e-2


def _moved(jscene):
    """The scene with its textured sphere shifted and shrunk: the fit's
    start, as numpy params."""
    p, _ = jsplit(jscene)
    p = {k: np.array(v) for k, v in p.items()}
    p["sph_center"][0] += np.float32([0.2, -0.1, 0.0])
    p["sph_radius"][0] *= np.float32(0.9)
    return p


def test_fit_matches_jax():
    """Three steps of ``fit`` from the same start reach JAX's losses and
    parameters. Each parameter's move from the start is held to the
    gradient tolerance against JAX's move (Adam moves each entry by about
    the learning rate, whatever the gradient's size)."""
    jscene, jcam = _textured_scene()
    target = np.asarray(jax_render_diff(jscene, jcam, W, H, SPP, DEPTH, seed=5))
    start = _moved(jscene)
    fields = ("sph_center", "sph_radius", "tex_color")
    kw = dict(spp=SPP, max_depth=DEPTH, steps=STEPS, learning_rate=LR, seed=5,
              optimize_fields=fields, edge_eps=(0.02, 0.04), coarse_to_fine=2.0)
    _, jstatic = jsplit(jscene)
    want = jax_fit(jmerge({k: jnp.asarray(v) for k, v in start.items()}, jstatic), jcam, target,
                   W, H, **kw)

    scene, camera = _cross(jscene, jcam)
    _, static = split_scene(scene)
    got = fit(merge_scene(params_from_numpy(start, "cpu"), static), camera, _t(target), W, H,
              device="cpu", **kw)
    assert got.losses.shape == (STEPS,)
    np.testing.assert_allclose(got.losses.numpy(), np.asarray(want.losses), rtol=1e-5)
    for f in fields:
        mw = np.asarray(getattr(want.scene, f)) - start[f]
        mg = getattr(got.scene, f).numpy() - start[f]
        assert np.abs(mw).max() > 0, f
        np.testing.assert_allclose(mg, mw, atol=GRAD_ATOL * np.abs(mw).max(), rtol=GRAD_RTOL,
                                   err_msg=f)
    # frozen fields stay as they were
    for f in ("mat_ior", "atlas"):
        np.testing.assert_array_equal(getattr(got.scene, f).numpy(), start[f])


def test_fd_gradients_match_jax():
    """Central differences of the same loss in both packages, with a step
    of 2e-2. The two packages' losses agree to a few f32 ulps, and the
    quotient divides a difference of losses by 2 * eps, so the bar is 16
    ulps of the loss over 2 * eps."""
    jscene, jcam = _simple_scene()
    jparams, jstatic = jsplit(jscene)
    target = np.full((6, 6, 3), 0.3, np.float32)
    jloss = jax.jit(jax_make_loss_fn(jstatic, jcam, jnp.asarray(target), 6, 6, 2, 2))
    want = jax_fd_gradients(jloss, jparams, ("sph_radius",), eps=FD_EPS)

    scene, camera = _cross(jscene, jcam)
    params, static = split_scene(scene)
    loss = make_loss_fn(static, camera, _t(target), 6, 6, 2, 2)
    got = fd_gradients(loss, params, ("sph_radius",), eps=FD_EPS)
    gw = np.asarray(want["sph_radius"])
    assert np.abs(gw).max() > 0
    ulp = np.spacing(np.float32(jloss(jparams)))
    np.testing.assert_allclose(got["sph_radius"].numpy(), gw, rtol=0,
                               atol=16 * ulp / (2 * FD_EPS))


def test_fit_refuses_what_waits():
    """The card is the default device and is required (checkpoints are
    held in tests/test_torch_checkpoint.py)."""
    jscene, jcam = _simple_scene()
    scene, camera = _cross(jscene, jcam)
    target = torch.zeros((4, 4, 3))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fit(scene, camera, target, 4, 4, steps=1)
