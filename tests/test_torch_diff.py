"""The port's differentiable path against the JAX package, on the CPU.

The same scenes and inputs go through both packages (numpy in between):
the bilinear texture lookup, the branch-gradient terms of ``scatter``, the
pose transforms, and ``render_diff``'s image and gradients on the mesh
scene of tests/test_diff_mesh.py. That scene has 72 triangles, so the
winner-recompute split and select-recompute engage, and ground, glass and
red spheres, so the REINFORCE term is live. Gradients are held to
tests/test_diff_mesh.py's tolerance, ``atol = 5e-4 * max|g_jax|`` and
``rtol = 2e-3`` per field.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_diff_mesh import _mesh_scene
from test_grad import _simple_scene
from zraytrace_tpu import materials as jmat
from zraytrace_tpu import scene as jsc
from zraytrace_tpu import textures as jtex
from zraytrace_tpu import transforms as jtr
from zraytrace_tpu.camera import make_camera as jax_make_camera
from zraytrace_tpu.geometry.bvh import build_tri_bvh as jax_build_tri_bvh
from zraytrace_tpu.inverse import make_loss_fn as jax_make_loss_fn
from zraytrace_tpu.inverse import split_scene as jsplit
from zraytrace_tpu.render_diff import render_diff as jax_render_diff
from zraytrace_tpu_torch import materials as mat
from zraytrace_tpu_torch import textures as tex
from zraytrace_tpu_torch import transforms as tr
from zraytrace_tpu_torch.convert import (
    camera_from_numpy,
    params_from_numpy,
    pose_from_numpy,
    scene_from_numpy,
)
from zraytrace_tpu_torch.diff_trace import (
    pack_for_diff,
    sphere_scan,
    trace_closest_diff,
    tri_winner_ids,
    winner_t,
)
from zraytrace_tpu_torch.inverse import DIFF_FIELDS, make_loss_fn, merge_scene, split_scene
from zraytrace_tpu_torch.render import camera_rays, wavefront_trace
from zraytrace_tpu_torch.render_diff import render_diff, trace_paths

torch.set_num_threads(1)

W = H = 12
SPP, DEPTH = 2, 3
EDGE_EPS = (0.01, 0.02)
GRAD_ATOL, GRAD_RTOL = 5e-4, 2e-3  # tests/test_diff_mesh.py:104-106


def _t(x):
    return torch.from_numpy(np.array(x))


def _cross(jscene, jcamera):
    scene = scene_from_numpy({k: np.asarray(v) for k, v in jscene._asdict().items()}, "cpu")
    return scene, camera_from_numpy(*map(np.asarray, jcamera), device="cpu")


def _assert_grads(got: dict, want: dict, fields):
    """Per field: the port's gradient (None: never reached, zero) against
    JAX's within the mesh-gradient tolerance. Returns the largest
    difference relative to each field's largest JAX gradient."""
    worst = {}
    for f in fields:
        gw = np.asarray(want[f])
        gg = np.zeros_like(gw) if got[f] is None else got[f].detach().numpy()
        assert np.isfinite(gg).all(), f
        scale = max(np.abs(gw).max(initial=0.0), 1e-12)
        np.testing.assert_allclose(gg, gw, atol=GRAD_ATOL * scale, rtol=GRAD_RTOL, err_msg=f)
        worst[f] = float(np.abs(gg - gw).max(initial=0.0) / scale)
    return worst


def _textured_scene():
    """Image textures of two sizes (one with non-default offsets, so the
    wrap engages) beside a color texture, on three spheres."""
    rng = np.random.default_rng(11)
    b = jsc.SceneBuilder()
    t0 = b.add_image_texture(rng.random((5, 7, 3)).astype(np.float32))
    t1 = b.add_image_texture(rng.random((4, 3, 3)).astype(np.float32), 0.3, 0.6)
    t2 = b.add_color_texture((0.2, 0.5, 0.7))
    b.add_sphere((0.0, 0.0, 3.0), 1.2, b.add_lambertian(t0))
    b.add_sphere((1.0, -52.0, 4.0), 50.0, b.add_lambertian(t1))
    b.add_sphere((-1.2, 0.3, 2.0), 0.6, b.add_metal(t2))
    cam = jax_make_camera((0, 0, -5.0), (0, 0, 1.0), (0, 1.0, 0), 45.0, 1.0)
    return b.build(), cam


@pytest.mark.parametrize("bilinear", [False, True], ids=["nearest", "bilinear"])
def test_texture_albedo_and_grads_match_jax(bilinear):
    """Albedo within 1e-6 of JAX's, and its gradients with respect to the
    atlas, the texture colors and uv (bilinear only: the nearest texel
    has none with respect to uv)."""
    jscene, jcam = _textured_scene()
    scene, _ = _cross(jscene, jcam)
    rng = np.random.default_rng(3)
    n = 400
    tex_id = rng.integers(0, jscene.tex_type.shape[0], n).astype(np.int32)
    uv = rng.random((n, 2)).astype(np.float32)
    uv[:8] = [[0, 0], [1, 1], [0, 1], [1, 0], [0.5, 0], [0, 0.5], [0.999, 0.001], [0.25, 1]]
    w = rng.random((n, 3)).astype(np.float32)

    def jloss(atlas, tex_color, juv):
        s = jscene._replace(atlas=atlas, tex_color=tex_color)
        return jnp.sum(jnp.asarray(w) * jtex.texture_albedo(s, jnp.asarray(tex_id), juv,
                                                             bilinear))

    want = np.asarray(jtex.texture_albedo(jscene, jnp.asarray(tex_id), jnp.asarray(uv), bilinear))
    want_g = jax.grad(jloss, argnums=(0, 1, 2))(jscene.atlas, jscene.tex_color, jnp.asarray(uv))

    atlas = scene.atlas.clone().requires_grad_(True)
    tex_color = scene.tex_color.clone().requires_grad_(True)
    tuv = _t(uv).requires_grad_(True)
    got = tex.texture_albedo(scene._replace(atlas=atlas, tex_color=tex_color), _t(tex_id), tuv,
                             bilinear)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-6)
    (_t(w) * got).sum().backward()
    grads = {"atlas": atlas.grad, "tex_color": tex_color.grad}
    fields = ("atlas", "tex_color")
    if bilinear:
        grads["uv"] = tuv.grad
        fields += ("uv",)
    _assert_grads(grads, dict(zip(("atlas", "tex_color", "uv"), want_g)), fields)


@pytest.fixture(scope="module")
def scatter_inputs():
    """Hits on every material type of the glass-and-triangle scene of
    tests/test_grad.py: random unit directions, normals flipped against
    them, both faces, random uv and uniforms."""
    jscene, _ = _simple_scene(with_tri=True, with_glass=True)
    rng = np.random.default_rng(8)
    n = 512
    unit = lambda x: (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)
    d_in = unit(rng.normal(size=(n, 3)))
    normal = unit(rng.normal(size=(n, 3)))
    normal = np.where((normal * d_in).sum(1, keepdims=True) > 0, -normal, normal)
    ins = dict(d_in=d_in, normal=normal.astype(np.float32), front_face=rng.random(n) < 0.6,
               uv=rng.random((n, 2)).astype(np.float32),
               mat_id=rng.integers(0, jscene.mat_type.shape[0], n).astype(np.int32),
               rnd=rng.random((n, 4)).astype(np.float32))
    return jscene, ins


def test_scatter_branch_grad_matches_jax(scatter_inputs):
    """Directions, attenuation, absorption, ``log_w`` and ``amp_mul``
    against JAX's (1e-6), and the gradient of ``log_w`` with respect to
    ``mat_ior``."""
    jscene, ins = scatter_inputs
    scene, _ = _cross(jscene, _simple_scene()[1])
    keys = ("d_in", "normal", "front_face", "uv", "mat_id", "rnd")
    jargs = [jnp.asarray(ins[k]) for k in keys]
    targs = [_t(ins[k]) for k in keys]
    w = np.random.default_rng(9).random(ins["d_in"].shape[0]).astype(np.float32)

    want = jmat.scatter(jscene, *jargs, bilinear_textures=True, branch_grad=True)
    ior = scene.mat_ior.clone().requires_grad_(True)
    got = mat.scatter(scene._replace(mat_ior=ior), *targs, bilinear_textures=True,
                      branch_grad=True)
    assert len(got) == 5
    for name, g, x in zip(("new_dir", "atten", "absorbed", "log_w", "amp_mul"), got, want):
        if name == "absorbed":
            assert np.array_equal(g.numpy(), np.asarray(x))
        else:
            np.testing.assert_allclose(g.detach().numpy(), np.asarray(x), rtol=0, atol=1e-6,
                                       err_msg=name)
    assert (got[3] != 0).any() and (got[4] == 0).any() and (got[4] > 1).any()
    assert not got[4].requires_grad  # amp_mul is detached

    def jloss(ior_):
        return jnp.sum(jnp.asarray(w) * jmat.scatter(jscene._replace(mat_ior=ior_), *jargs,
                                                     branch_grad=True)[3])

    (_t(w) * got[3]).sum().backward()
    _assert_grads({"mat_ior": ior.grad}, {"mat_ior": jax.grad(jloss)(jscene.mat_ior)},
                  ("mat_ior",))


def test_branch_grad_isolation():
    """tests/test_grad.py:185 in the port: the REINFORCE term changes the
    image nowhere and every gradient but ``mat_ior``'s not at all (bit for
    bit), while the ``mat_ior`` gradient changes and stays finite."""
    jscene, jcam = _simple_scene(with_glass=True)
    scene, camera = _cross(jscene, jcam)
    params, static = split_scene(scene)

    def run(bg):
        p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
        img = render_diff(merge_scene(p, static), camera, 8, 8, 4, 4, seed=7, branch_grad=bg)
        img.mean().backward()
        return img.detach(), {k: v.grad for k, v in p.items()}

    img_on, g_on = run(True)
    img_off, g_off = run(False)
    assert torch.equal(img_on, img_off)
    for k in g_on:
        if k == "mat_ior":
            continue
        assert (g_on[k] is None) == (g_off[k] is None), k
        if g_on[k] is not None:
            assert torch.equal(g_on[k], g_off[k]), k
    assert torch.isfinite(g_on["mat_ior"]).all()
    assert not torch.equal(g_on["mat_ior"], g_off["mat_ior"])


@pytest.mark.parametrize("aa", [(0.0, 0.0, 0.0), (1e-9, 0.0, 0.0), (0.3, -0.2, 0.5),
                                (2.0, 1.0, -1.5)])
def test_rotation_matrix_matches_jax(aa):
    want = np.asarray(jtr.rotation_matrix(jnp.asarray(aa, jnp.float32)))
    got = tr.rotation_matrix(torch.tensor(aa, dtype=torch.float32))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_transforms_match_jax():
    """Moved triangles and spheres, each with and without a mask, within
    1e-6 relative to the coordinates (about 5 in size)."""
    jscene, jcam = _mesh_scene()
    scene, _ = _cross(jscene, jcam)
    rng = np.random.default_rng(4)
    jpose = jtr.Pose(jnp.asarray([0.3, -0.1, 0.2], jnp.float32),
                     jnp.asarray([0.2, 0.4, -0.3], jnp.float32), jnp.float32(1.3))
    pose = pose_from_numpy(*map(np.asarray, jpose), device="cpu")
    tri_mask = rng.random(jscene.n_triangles) < 0.5
    sph_mask = np.array([False, True, True])
    for jm, tm in ((None, None), (jnp.asarray(tri_mask), _t(tri_mask))):
        want = jtr.transform_triangles(jscene, jpose, jm)
        got = tr.transform_triangles(scene, pose, tm)
        for f in ("tri_a", "tri_b", "tri_c"):
            np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                       rtol=1e-6, atol=1e-6, err_msg=f)
    for jm, tm in ((None, None), (jnp.asarray(sph_mask), _t(sph_mask))):
        want = jtr.transform_spheres(jscene, jpose, jm)
        got = tr.transform_spheres(scene, pose, tm)
        for f in ("sph_center", "sph_radius"):
            np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                       rtol=1e-6, atol=1e-6, err_msg=f)


def test_pose_gradient_through_render_diff_matches_jax():
    """A pose of the 72-triangle grid receives JAX's gradient through
    ``render_diff`` with edge factors."""
    jscene, jcam = _mesh_scene()
    scene, camera = _cross(jscene, jcam)
    jpose = jtr.Pose(jnp.asarray([0.05, -0.03, 0.02], jnp.float32),
                     jnp.asarray([0.02, 0.05, -0.01], jnp.float32), jnp.float32(1.02))

    def jloss(p):
        img = jax_render_diff(jtr.transform_triangles(jscene, p), jcam, 8, 8, 1, 2,
                              edge_eps=EDGE_EPS)
        return jnp.mean((img - 0.25) ** 2)

    want = jax.grad(jloss)(jpose)
    pose = tr.Pose(*(x.requires_grad_(True)
                     for x in pose_from_numpy(*map(np.asarray, jpose), device="cpu")))
    img = render_diff(tr.transform_triangles(scene, pose), camera, 8, 8, 1, 2, edge_eps=EDGE_EPS)
    ((img - 0.25) ** 2).mean().backward()
    got = {f: getattr(pose, f).grad for f in tr.Pose._fields}
    assert all(got[f].abs().max() > 0 for f in got)
    _assert_grads(got, want._asdict(), tr.Pose._fields)


@pytest.fixture(scope="module")
def mesh_run():
    """JAX's image and ``jax.grad`` of the image loss on the mesh scene,
    12x12 at 2 spp and depth 3, edge factors and REINFORCE on."""
    jscene, jcam = _mesh_scene()
    jparams, jstatic = jsplit(jscene)
    target = np.full((H, W, 3), 0.25, np.float32)
    jloss = jax_make_loss_fn(jstatic, jcam, jnp.asarray(target), W, H, SPP, DEPTH,
                             edge_eps=EDGE_EPS)
    img = np.asarray(jax_render_diff(jscene, jcam, W, H, SPP, DEPTH, edge_eps=EDGE_EPS))
    return dict(jscene=jscene, jcam=jcam, jparams=jparams, target=target, img=img,
                loss=float(jloss(jparams)), grads=jax.grad(jloss)(jparams))


def test_render_diff_forward_matches_jax_and_wavefront(mesh_run):
    """The image equals JAX's ``render_diff`` image and, with nearest
    textures, the port's own wavefront image, both within 2e-5."""
    scene, camera = _cross(mesh_run["jscene"], mesh_run["jcam"])
    img = render_diff(scene, camera, W, H, SPP, DEPTH, edge_eps=EDGE_EPS)
    assert img.shape == (H, W, 3)
    np.testing.assert_allclose(img.detach().numpy(), mesh_run["img"], rtol=0, atol=2e-5)
    nearest = render_diff(scene, camera, W, H, SPP, DEPTH, bilinear_textures=False)
    sums, _ = wavefront_trace(scene, camera, torch.arange(W * H, dtype=torch.int32), 42, W, H,
                              SPP, DEPTH, 0, W * H, W * H, 1)
    np.testing.assert_allclose(nearest.detach().numpy(),
                               (sums[0] / SPP).reshape(H, W, 3).numpy(), rtol=0, atol=2e-5)


@pytest.mark.parametrize("route", ["auto", "tri_order"])
def test_render_diff_grads_match_jax(mesh_run, route):
    """``make_loss_fn``'s loss and its gradient for every ``DIFF_FIELDS``
    entry against ``jax.grad``. ``auto``: the CPU default, the brute
    winner and the brute selection. ``tri_order``: BVH-ordered planes
    repacked per evaluation, so the winner pass runs the plain flash
    winner and the selection ``flash_margin_select_plain`` (the kernels'
    plain versions). The JAX side takes its brute routes at 144 lanes."""
    scene, camera = _cross(mesh_run["jscene"], mesh_run["jcam"])
    params = params_from_numpy({k: np.asarray(v) for k, v in mesh_run["jparams"].items()}, "cpu")
    _, static = split_scene(scene)
    order = None
    if route == "tri_order":
        js = mesh_run["jscene"]
        order = _t(np.asarray(jax_build_tri_bvh(js.tri_a, js.tri_b, js.tri_c).prim_order))
    loss_fn = make_loss_fn(static, camera, _t(mesh_run["target"]), W, H, SPP, DEPTH,
                           edge_eps=EDGE_EPS, tri_order=order)
    p = {k: v.requires_grad_(True) for k, v in params.items()}
    loss = loss_fn(p)
    np.testing.assert_allclose(float(loss.detach()), mesh_run["loss"], rtol=1e-5)
    loss.backward()
    assert set(DIFF_FIELDS) == set(mesh_run["grads"])
    worst = _assert_grads({k: v.grad for k, v in p.items()}, mesh_run["grads"], DIFF_FIELDS)
    print(f"largest |g - g_jax| / max|g_jax| ({route}):",
          {k: float(f"{v:.3g}") for k, v in worst.items()})


@pytest.mark.parametrize("route", ["brute", "planes"])
def test_winner_t_equals_trace_closest_diff(mesh_run, route):
    """The selection's ``t_cap`` that ``trace_paths`` builds from the winner
    pass alone equals ``trace_closest_diff``'s hit distance bit for bit,
    on camera rays and on one bounce of them."""
    scene, camera = _cross(mesh_run["jscene"], mesh_run["jcam"])
    pix = torch.arange(W * H, dtype=torch.int32)
    o, d = camera_rays(camera, 42, pix, torch.zeros_like(pix), W, H)
    planes = pack_for_diff(scene) if route == "planes" else None
    for _ in range(2):
        ts, _ = sphere_scan(scene, o, d)
        winner = tri_winner_ids(scene, o, d, ts, tri_flash=planes)
        h = trace_closest_diff(scene, o, d, winner=winner)
        assert winner.use_tri.any() and h["hit"].any()
        assert torch.equal(winner_t(scene, o, d, ts, winner), h["t"])
        # reflect about the normal: the second pass starts on the surfaces
        refl = d - 2.0 * (d * h["normal"]).sum(-1, keepdim=True) * h["normal"]
        o, d = torch.where(h["hit"][:, None], h["point"], o), refl


def test_trace_paths_remat_off_matches_remat_on(mesh_run):
    """``trace_paths`` without the per-bounce checkpoint: the same radiance
    and the same gradient for every ``DIFF_FIELDS`` entry as with it (the
    default ``render_diff`` takes), edge factors and REINFORCE on."""
    scene, camera = _cross(mesh_run["jscene"], mesh_run["jcam"])
    params, static = split_scene(scene)
    pix = torch.arange(W * H, dtype=torch.int32)
    weights = _t(np.random.default_rng(12).random((W * H, 3)).astype(np.float32))

    def run(remat):
        p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
        r = trace_paths(merge_scene(p, static), camera, pix, torch.zeros_like(pix), 42, W, H,
                        DEPTH, remat=remat, edge_eps=EDGE_EPS, branch_grad=True)
        (weights * r).sum().backward()
        return r.detach(), {k: v.grad for k, v in p.items()}

    r_on, g_on = run(True)
    r_off, g_off = run(False)
    assert torch.equal(r_on, r_off)
    assert any(g is not None and g.abs().max() > 0 for g in g_on.values())
    for k in DIFF_FIELDS:
        assert (g_on[k] is None) == (g_off[k] is None), k
        if g_on[k] is not None:
            assert torch.equal(g_on[k], g_off[k]), k


def test_textured_render_diff_grads_match_jax():
    """The bilinear image path through ``render_diff``: the gradient of
    every ``DIFF_FIELDS`` entry, the atlas's included, on the textured
    sphere scene at 8x8, 2 spp, depth 3, with edge factors."""
    jscene, jcam = _textured_scene()
    jparams, jstatic = jsplit(jscene)
    target = np.full((8, 8, 3), 0.3, np.float32)
    jloss = jax_make_loss_fn(jstatic, jcam, jnp.asarray(target), 8, 8, 2, 3, edge_eps=EDGE_EPS)
    want = jax.grad(jloss)(jparams)
    assert np.abs(np.asarray(want["atlas"])).max() > 0
    scene, camera = _cross(jscene, jcam)
    params, static = split_scene(scene)
    p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    make_loss_fn(static, camera, _t(target), 8, 8, 2, 3, edge_eps=EDGE_EPS)(p).backward()
    _assert_grads({k: v.grad for k, v in p.items()}, want, DIFF_FIELDS)
