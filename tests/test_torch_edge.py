"""The port's edge gradients and margin selection against the JAX package,
on the CPU.

``flash_margin_select_plain`` is the function the CUDA margin kernel
(``csrc/flash_margins.cu``) is held to bit for bit on the card; here it is
held to JAX's ``flash_margin_select`` (interpret mode, as
tests/test_edge_grad.py runs it) and to JAX's brute selection scan, on
teapot camera rays and rays leaving the teapot's surface. The bar is the
JAX test's own: the selected triangles' margins agree, or both sit in the
saturated zone (near-miss margins below -0.5, occlusion margins above
0.5), on all but 2% of the rays.

Tolerances. XLA's CPU backend forms the selection scan's dot products as
fused multiply-adds; the port rounds every product. A margin is a
difference of terms far larger than itself divided by a small
determinant, so two engines that select the same triangle agree to
``MARGIN_ATOL`` (measured up to about 1e-5), not bit for bit. Gradients
use the JAX package's mesh-gradient tolerance (tests/test_diff_mesh.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_diff_mesh import _mesh_scene
from test_grad import _simple_scene
from zraytrace_tpu import edge_grad as jeg
from zraytrace_tpu import scene as jsc
from zraytrace_tpu.camera import get_rays as jax_get_rays
from zraytrace_tpu.camera import make_camera as jax_make_camera
from zraytrace_tpu.geometry.bvh import build_tri_bvh as jax_build_tri_bvh
from zraytrace_tpu.io.obj import read_obj as jax_read_obj
from zraytrace_tpu.ops import flash_intersect as jfi
from zraytrace_tpu.render import trace_closest as jax_trace_closest
from zraytrace_tpu.scenes import assets_dir
from zraytrace_tpu_torch import edge_grad as eg
from zraytrace_tpu_torch.convert import scene_from_numpy
from zraytrace_tpu_torch.diff_trace import trace_closest_diff
from zraytrace_tpu_torch.ops import flash_intersect as fi
from zraytrace_tpu_torch.render import trace_closest

from torch_jax_native import jax_native  # noqa: F401  (an autouse fixture)

torch.set_num_threads(1)

T_MIN = 1e-3
MARGIN_ATOL = 1e-4
RESIDUAL = 0.02  # tests/test_edge_grad.py:282
# At most this share of the rays may be ones the JAX package classifies
# wrongly (``_jax_misclassified``).
MISCLASSIFIED = 0.05


def _t(x):
    return torch.from_numpy(np.array(x))


def _cross(jscene):
    return scene_from_numpy({k: np.asarray(v) for k, v in jscene._asdict().items()}, "cpu")


def _teapot_rays(n=256, seed=7):
    """tests/test_edge_grad.py:226-255: the teapot on a ground sphere, 256
    camera rays and 256 rays leaving the teapot's surface in random
    directions."""
    model = jax_read_obj(assets_dir() / "teapot/teapot.obj")
    a0, b0, c0 = (np.asarray(x) for x in model.tri_vertices)
    b = jsc.SceneBuilder()
    b.add_sphere((0.0, -102.33, 7.0), 100.0, b.add_lambertian_color(jsc.COLOR_GREEN))
    b.add_triangles(a0, b0, c0, b.add_lambertian_color((0.7, 0.15, 0.1)))
    scene = b.build()
    rng = np.random.default_rng(seed)
    camera = jax_make_camera((0.0, 3.0, -9.0), (0.0, 1.0, 5.0), (0.0, 1.0, 0.0), 50.0, 1.0)
    u = jnp.asarray(rng.random(n) * 0.8 + 0.1, jnp.float32)
    v = jnp.asarray(rng.random(n) * 0.8 + 0.1, jnp.float32)
    o1, d1 = (np.asarray(x) for x in jax_get_rays(camera, u, v))
    ti = rng.integers(0, a0.shape[0], n)
    w1 = rng.random((n, 1))
    w2 = rng.random((n, 1)) * (1 - w1)
    o2 = (a0[ti] * (1 - w1 - w2) + b0[ti] * w1 + c0[ti] * w2).astype(np.float32)
    d2 = rng.normal(size=(n, 3))
    d2 = (d2 / np.linalg.norm(d2, axis=1, keepdims=True)).astype(np.float32)
    return scene, {"camera": (o1, d1), "surface": (o2, d2)}


@pytest.fixture(scope="module")
def teapot():
    jscene, rays = _teapot_rays()
    order = np.asarray(jax_build_tri_bvh(jscene.tri_a, jscene.tri_b, jscene.tri_c).prim_order)
    jtf = jfi.pack_tri_planes(jscene.tri_a, jscene.tri_b, jscene.tri_c, order=order)
    tscene = _cross(jscene)
    ttf = fi.pack_tri_planes(tscene.tri_a, tscene.tri_b, tscene.tri_c, order=_t(order))
    out = {}
    for name, (o, d) in rays.items():
        jo, jd = jnp.asarray(o), jnp.asarray(d)
        jh = jax_trace_closest(jscene, jo, jd)
        th = trace_closest(tscene, _t(o), _t(d))
        t_cap = np.where(np.asarray(jh["hit"]), np.asarray(jh["t"]), np.float32(3.4e38))
        out[name] = dict(
            o=o, d=d, jh=jh, th=th,
            jax_flash=[np.asarray(x) for x in jfi.flash_margin_select(jtf, jo, jd, jnp.asarray(t_cap),
                                                                      T_MIN)],
            jax_margins={
                (scr, route): [np.asarray(x) for x in jeg.silhouette_margin(
                    jscene, jo, jd, jh, tri_flash=tf, screen=scr)]
                for scr in (False, True) for route, tf in (("brute", None), ("flash", jtf))})
    return dict(jscene=jscene, tscene=tscene, ttf=ttf, rays=out)


def _margin_t(jscene, o, d, ids, empty=-np.inf):
    """Relative margin and t of triangle ``ids`` per ray, in float64
    (``empty`` for both where the id is -1)."""
    a, b, c = (np.asarray(x, np.float64)[np.maximum(ids, 0)]
               for x in (jscene.tri_a, jscene.tri_b, jscene.tri_c))
    o, d = o.astype(np.float64), d.astype(np.float64)
    e1, e2 = b - a, c - a
    fn = np.cross(e1, e2)
    det = -(d * fn).sum(-1)
    oxd = np.cross(o, d)
    u = ((oxd * e2).sum(-1) - (d * np.cross(e2, a)).sum(-1)) / det
    v = -((oxd * e1).sum(-1) - (d * np.cross(e1, a)).sum(-1)) / det
    t = ((o * fn).sum(-1) - (a * fn).sum(-1)) / det
    m = np.minimum(np.minimum(u, v), 1.0 - u - v)
    return np.where(ids >= 0, m, empty), np.where(ids >= 0, t, empty)


def _agree(a, b, kind):
    """The JAX test's bar: equal (here within MARGIN_ATOL) or saturated
    on both sides."""
    a, b = np.asarray(a), np.asarray(b)
    same = np.abs(a - b) <= MARGIN_ATOL
    saturated = ((a > 0.5) & (b > 0.5)) if kind == "occ" else ((a < -0.5) & (b < -0.5))
    return same | saturated


@pytest.mark.parametrize("rays", ["camera", "surface"])
def test_margin_select_plain_matches_jax_flash_ids(teapot, rays):
    """The plain selection picks JAX's flash-kernel triangles: the same
    ids, except where both candidates are saturated."""
    r = teapot["rays"][rays]
    th = r["th"]
    t_cap = torch.where(th["hit"], th["t"], 3.4e38)
    got = fi.flash_margin_select_plain(teapot["ttf"], _t(r["o"]), _t(r["d"]), t_cap, T_MIN)
    # and the CPU wrapper runs exactly the plain version
    wrapped = fi.flash_margin_select(teapot["ttf"], _t(r["o"]), _t(r["d"]), t_cap, T_MIN)
    for g, w in zip(got, wrapped):
        assert torch.equal(g, w)
    near, occ, win = (g.numpy() for g in got)
    j_near, j_occ, j_win = r["jax_flash"]
    assert (near >= 0).any() and (occ >= 0).any() and (win >= 0).any()
    # different near-miss picks are both saturated: the TPU kernel also
    # visits chunks that other rays of its 128-ray block reach
    m, _ = _margin_t(teapot["jscene"], r["o"], r["d"], near)
    m_j, _ = _margin_t(teapot["jscene"], r["o"], r["d"], j_near)
    ok = (near == j_near) | ((m < -0.5) & (m_j < -0.5))
    assert ok.mean() >= 1.0 - RESIDUAL, (1.0 - ok.mean(), np.argwhere(~ok)[:5, 0])
    t_cap = t_cap.numpy().astype(np.float64)
    _, t = _margin_t(teapot["jscene"], r["o"], r["d"], occ, empty=np.inf)
    _, t_j = _margin_t(teapot["jscene"], r["o"], r["d"], j_occ, empty=np.inf)
    with np.errstate(invalid="ignore"):  # inf / inf where neither found one: equal ids
        ok = (occ == j_occ) | (((t - t_cap) / t > 0.5) & ((t_j - t_cap) / t_j > 0.5))
    assert ok.mean() >= 1.0 - RESIDUAL, (1.0 - ok.mean(), np.argwhere(~ok)[:5, 0])
    assert (win == j_win).mean() >= 1.0 - RESIDUAL


def _near_excused(teapot, r, screen):
    """Rays whose flash-route near-miss picks differ between the port and
    JAX with both picks saturated in the RELATIVE margin the kernels
    select by (below -0.5). Their screen margins differ arbitrarily: a
    relatively saturated near miss can have any angular margin."""
    sel = eg.select_margin_ids(teapot["tscene"], _t(r["o"]), _t(r["d"]), r["th"],
                               screen=screen, tri_flash=teapot["ttf"])
    near, j_near = sel.near.numpy(), r["jax_flash"][0]
    m, _ = _margin_t(teapot["jscene"], r["o"], r["d"], near)
    m_j, _ = _margin_t(teapot["jscene"], r["o"], r["d"], j_near)
    return (near != j_near) & (m < -0.5) & (m_j < -0.5)


@pytest.mark.parametrize("screen", [False, True], ids=["relative", "screen"])
@pytest.mark.parametrize("rays", ["camera", "surface"])
@pytest.mark.parametrize("route", ["flash", "brute"])
def test_silhouette_margin_matches_jax_teapot(teapot, rays, screen, route):
    """The port's margins through each selection route against the JAX
    package's same route: the flash route (original-id planes, the plain
    selection here) against JAX's flash kernel, the brute scan against
    JAX's brute scan. In screen mode the flash route also excuses the
    rays whose near-miss picks differ while both are saturated in the
    relative margin the selection ranks by (``_near_excused``)."""
    r = teapot["rays"][rays]
    tf = teapot["ttf"] if route == "flash" else None
    got = eg.silhouette_margin(teapot["tscene"], _t(r["o"]), _t(r["d"]), r["th"], tri_flash=tf,
                               screen=screen)
    want = r["jax_margins"][(screen, route)]
    excused = (_near_excused(teapot, r, screen) if screen and route == "flash"
               else np.zeros(r["o"].shape[0], bool))
    for name, g, w in zip(("margin", "occ", "near"), got, want):
        ok = _agree(g.numpy(), w, name) | (excused if name != "occ" else False)
        assert 1.0 - ok.mean() <= RESIDUAL, (name, 1.0 - ok.mean(), np.argwhere(~ok)[:5, 0])


@pytest.mark.parametrize("rays", ["camera", "surface"])
def test_flash_route_matches_jax_brute(teapot, rays):
    """tests/test_edge_grad.py:210 across the packages: the port's flash
    route (the plain selection) against JAX's brute scan, relative
    margins, with the JAX test's bar."""
    r = teapot["rays"][rays]
    got = eg.silhouette_margin(teapot["tscene"], _t(r["o"]), _t(r["d"]), r["th"],
                               tri_flash=teapot["ttf"])
    for name, g, w in zip(("margin", "occ", "near"), got, r["jax_margins"][(False, "brute")]):
        ok = _agree(g.numpy(), w, name)
        assert 1.0 - ok.mean() <= RESIDUAL, (name, 1.0 - ok.mean(), np.argwhere(~ok)[:5, 0])


def test_teapot_on_ground_is_the_jax_fit_scene(teapot):
    """``scenes.teapot_on_ground`` builds tools/diff_bench.py's pose-fit
    scene, field for field, with its camera."""
    from zraytrace_tpu_torch.scenes import teapot_on_ground

    built = teapot_on_ground("cpu")
    for k in teapot["jscene"]._fields:
        assert np.array_equal(getattr(built.scene, k).numpy(),
                              np.asarray(getattr(teapot["jscene"], k))), k
    jcam = jax_make_camera((0.0, 3.0, -9.0), (0.0, 1.0, 5.0), (0.0, 1.0, 0.0), 50.0, 1.0)
    for got, want in zip(built.camera, jcam):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("rays", ["camera", "surface"])
def test_screen_selection_follows_jax_flash(teapot, rays):
    """Which selection the port follows in screen mode (ROADMAP Queue 3
    (a)): JAX's brute scan picks the near miss and the winner by the
    angular margin, its flash kernel (and so the port's flash route, on
    the card and here) by the relative margin and the winner by least t.
    The port's flash route picks JAX's flash triangles on all but 2% of
    the rays (or both picks are relatively saturated), and its winner ids
    equal JAX's flash winner ids; its margins agree with JAX's flash
    route at least as often as with JAX's brute route."""
    r = teapot["rays"][rays]
    sel = eg.select_margin_ids(teapot["tscene"], _t(r["o"]), _t(r["d"]), r["th"], screen=True,
                               tri_flash=teapot["ttf"])
    excused = _near_excused(teapot, r, True)
    ok_ids = (sel.near.numpy() == r["jax_flash"][0]) | excused
    assert 1.0 - ok_ids.mean() <= RESIDUAL, 1.0 - ok_ids.mean()
    assert (sel.win.numpy() == r["jax_flash"][2]).mean() >= 1.0 - RESIDUAL
    got = eg.silhouette_margin(teapot["tscene"], _t(r["o"]), _t(r["d"]), r["th"],
                               tri_flash=teapot["ttf"], screen=True)
    flash = r["jax_margins"][(True, "flash")]
    brute = r["jax_margins"][(True, "brute")]
    ok_flash = _agree(got[2].numpy(), flash[2], "near")
    ok_brute = _agree(got[2].numpy(), brute[2], "near")
    assert ok_flash.mean() >= ok_brute.mean()


def test_margin_select_refuses_packed_ids(teapot):
    tf = fi.pack_tri_planes(teapot["tscene"].tri_a, teapot["tscene"].tri_b,
                            teapot["tscene"].tri_c, tri_mat=teapot["tscene"].tri_mat,
                            const_materials=True)
    o = torch.zeros((4, 3))
    d = torch.tensor([[0.0, 0.0, 1.0]] * 4)
    with pytest.raises(ValueError, match="original ids"):
        fi.flash_margin_select(tf, o, d, torch.full((4,), 3.4e38), T_MIN)


def _scene_rays(kind, n=96, seed=3):
    """Scenes with spheres only, one triangle (T < 64: JAX's dense scan)
    and the 72-triangle grid (T >= 64: JAX's select-recompute), with
    camera rays across the image."""
    if kind == "spheres":
        jscene, jcam = _simple_scene(with_glass=True)
    elif kind == "tri1":
        jscene, jcam = _simple_scene(with_tri=True, with_glass=True)
    else:
        jscene, jcam = _mesh_scene()
    rng = np.random.default_rng(seed)
    u = jnp.asarray(rng.random(n), jnp.float32)
    v = jnp.asarray(rng.random(n), jnp.float32)
    o, d = (np.asarray(x) for x in jax_get_rays(jcam, u, v))
    return jscene, o, d


def _jax_misclassified(jscene, jo, jd, jh, jax_margin):
    """Hit rays whose winner is a sphere (JAX's own sphere and triangle
    scans: spheres win ties) while JAX's ``silhouette_margin`` returns the
    triangle formula on the sphere's uv. Its sphere re-solve there rounds
    the winner's t above the trace's (XLA contracts the products into
    FMAs, ROADMAP Queue 3 (b2)), so ``h["t"] < t_best`` calls the hit a
    triangle's. The port's re-solve returns the trace's t and keeps the
    sphere margin. Such rays are left out of the comparison."""
    from zraytrace_tpu.geometry.sphere import intersect_spheres as jis
    from zraytrace_tpu.geometry.triangle import intersect_triangles as jit_

    n = jo.shape[0]
    if jscene.n_spheres == 0 or jscene.n_triangles == 0:
        return np.zeros(n, bool)
    ts = np.asarray(jis(jo, jd, jscene.sph_center, jscene.sph_radius, T_MIN, 3.4e38)[0])
    tt = np.asarray(jit_(jo, jd, jscene.tri_a, jscene.tri_b, jscene.tri_c, T_MIN, 3.4e38)[0])
    u, v = jh["uv"][:, 0], jh["uv"][:, 1]
    tri_formula = np.asarray(jnp.minimum(jnp.minimum(u, v), 1.0 - u - v))
    return np.asarray(jh["hit"]) & (ts <= tt) & (np.asarray(jax_margin) == tri_formula)


@pytest.mark.parametrize("screen", [False, True], ids=["relative", "screen"])
@pytest.mark.parametrize("kind", ["spheres", "tri1", "grid72"])
def test_silhouette_margin_values_and_grads_match_jax(kind, screen):
    """The three outputs of silhouette_margin equal JAX's, and so do their
    gradients with respect to the scene: the port's select-recompute
    against JAX's dense scan below 64 triangles and its select-recompute
    from 64 up (the brute selection on both sides). Rays JAX itself
    misclassifies (``_jax_misclassified``, 2 of 96 on the grid) carry no
    weight."""
    from zraytrace_tpu.inverse import merge_scene as jmerge
    from zraytrace_tpu.inverse import split_scene as jsplit
    from zraytrace_tpu_torch.inverse import merge_scene, split_scene

    jscene, o, d = _scene_rays(kind)
    jo, jd = jnp.asarray(o), jnp.asarray(d)
    jh = jax_trace_closest(jscene, jo, jd)
    fields = ("sph_center", "sph_radius") + (("tri_a", "tri_b", "tri_c")
                                              if jscene.n_triangles else ())
    want = jeg.silhouette_margin(jscene, jo, jd, jh, screen=screen)
    skip = _jax_misclassified(jscene, jo, jd, jh, want[0])
    assert skip.mean() <= MISCLASSIFIED, skip.mean()
    weights = np.random.default_rng(5).random((3, o.shape[0])).astype(np.float32)
    weights[:, skip] = 0.0

    def jloss(p):
        s = jmerge(p, jst)
        h = jax_trace_closest(s, jo, jd)
        outs = jeg.silhouette_margin(s, jo, jd, h, screen=screen)
        return sum(jnp.sum(jnp.asarray(w) * jnp.clip(x, -2.0, 2.0)) for w, x in zip(weights, outs))

    jp, jst = jsplit(jscene)
    want_g = jax.grad(jloss)({k: v for k, v in jp.items()})

    tscene = _cross(jscene)
    p, st = split_scene(tscene)
    p = {k: v.clone().requires_grad_(k in fields) for k, v in p.items()}
    s = merge_scene(p, st)
    th = (trace_closest_diff(s, _t(o), _t(d)) if s.n_triangles >= 64
          else trace_closest(s, _t(o), _t(d)))
    got = eg.silhouette_margin(s, _t(o), _t(d), th, screen=screen)
    for name, g, w in zip(("margin", "occ", "near"), got, want):
        np.testing.assert_allclose(g.detach().numpy()[~skip], np.asarray(w)[~skip], rtol=1e-5,
                                   atol=MARGIN_ATOL, err_msg=name)
    loss = sum((torch.from_numpy(w) * torch.clamp(x, -2.0, 2.0)).sum()
               for w, x in zip(weights, got))
    loss.backward()
    for f in fields:
        gw = np.asarray(want_g[f])
        gg = p[f].grad.numpy()
        np.testing.assert_allclose(gg, gw, atol=5e-4 * max(np.abs(gw).max(), 1e-12), rtol=2e-3,
                                   err_msg=f)


@pytest.mark.parametrize("kernel", ["log", "exact"])
def test_edge_factor_is_exactly_one_forward(kernel):
    """Forward, the edge factor is exactly 1.0 on every ray, whatever the
    margins; its gradient is not zero."""
    jscene, o, d = _scene_rays("grid72")
    scene = _cross(jscene)
    p = scene.tri_a.clone().requires_grad_(True)
    s = scene._replace(tri_a=p)
    h = trace_closest_diff(s, _t(o), _t(d))
    f = eg.edge_factor(s, _t(o), _t(d), h, (0.01, 0.02), kernel=kernel,
                       eps_scale=torch.full((o.shape[0],), 1.5))
    assert torch.equal(f.detach(), torch.ones_like(f))
    f.sum().backward()
    assert p.grad.abs().max() > 0


def test_edge_factor_matches_jax():
    """edge_factor's gradient (camera-weighted occlusion, a bandwidth pair,
    an amplification) equals JAX's."""
    from zraytrace_tpu.inverse import merge_scene as jmerge
    from zraytrace_tpu.inverse import split_scene as jsplit
    from zraytrace_tpu_torch.inverse import merge_scene, split_scene

    jscene, o, d = _scene_rays("grid72")
    jo, jd = jnp.asarray(o), jnp.asarray(d)
    jh = jax_trace_closest(jscene, jo, jd)
    skip = _jax_misclassified(jscene, jo, jd, jh, jeg.silhouette_margin(jscene, jo, jd, jh)[0])
    keep = (~skip).astype(np.float32)
    amp = np.random.default_rng(2).uniform(1.0, 3.0, o.shape[0]).astype(np.float32)
    jp, jst = jsplit(jscene)

    def jloss(p):
        s = jmerge(p, jst)
        h = jax_trace_closest(s, jo, jd)
        return jnp.sum(jnp.asarray(keep) * jeg.edge_factor(
            s, jo, jd, h, (0.01, 0.02), eps_scale=jnp.asarray(amp), occ_weight=jnp.float32(0.5)))

    want = jax.grad(jloss)(jp)
    p, st = split_scene(_cross(jscene))
    p = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    s = merge_scene(p, st)
    h = trace_closest_diff(s, _t(o), _t(d))
    (_t(keep) * eg.edge_factor(s, _t(o), _t(d), h, (0.01, 0.02), eps_scale=_t(amp),
                               occ_weight=0.5)).sum().backward()
    for f in ("sph_center", "sph_radius", "tri_a", "tri_b", "tri_c"):
        gw = np.asarray(want[f])
        np.testing.assert_allclose(p[f].grad.numpy(), gw, atol=5e-4 * max(np.abs(gw).max(), 1e-12),
                                   rtol=2e-3, err_msg=f)
