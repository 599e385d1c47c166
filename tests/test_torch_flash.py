"""The port's flash triangle winner against the JAX package, on the CPU.

The plain ``flash_intersect_plain`` is the function the CUDA kernel
(``csrc/flash_intersect.cu``) is held to bit for bit on the card; here it
is held to JAX's ``flash_intersect_triangles`` run in interpret mode (as
tests/test_flash.py runs it) and to JAX's brute ``intersect_triangles``.

Tolerances. XLA's CPU backend contracts ``a1*b2 - a2*b1`` and the dot
products into fused multiply-adds and approximates ``rsqrt``; the port
rounds every product separately (as its kernels do, built with
``-fmad=false``) and divides by a correctly rounded square root. So:
hit and winner id exact; the layout planes (edges, valid, ids) and chunk
bounds bitwise; cross-product planes within 2 f32 ulps of each plane's
largest value (cancellation makes small entries differ by more ulps of
their own); unit normals within 2 ulps; t relative 1e-4. The barycentric
u and v of rays from 12 units away are differences of terms ~100 times
larger, divided by a small determinant: they are held to 2e-3 absolute
(up to 1.2e-3 seen; no reference scene reads triangle uv).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zraytrace_tpu import vecmath as jvm
from zraytrace_tpu.geometry.bvh import build_tri_bvh as jax_build_tri_bvh
from zraytrace_tpu.geometry.triangle import intersect_triangles as jax_intersect_triangles
from zraytrace_tpu.ops import flash_intersect as jfi
from zraytrace_tpu.scenes import teapot_and_ball as jax_teapot
from zraytrace_tpu_torch.convert import tri_planes_from_numpy
from zraytrace_tpu_torch.geometry.triangle import intersect_triangles
from zraytrace_tpu_torch.ops import flash_intersect as fi
from zraytrace_tpu_torch.profiling import counter

import test_torch_winner_ties as ties

torch.set_num_threads(1)

EPS32 = float(np.finfo(np.float32).eps)
LAYOUT = (0, 1, 2, 3, 4, 5, 16, 17)  # e1, e2, valid, orig id: no products
T_MIN = 1e-3
UV_ATOL = 2e-3


def _soup(seed, n_tris, n_rays=128):
    """tests/test_flash.py's triangle soup and rays aimed at centroids."""
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(n_tris, 3)) * 5
    a, b, c = ((base + rng.normal(size=(n_tris, 3)) * 0.4).astype(np.float32)
               for _ in range(3))
    o = (rng.normal(size=(n_rays, 3)) * 12).astype(np.float32)
    tgt = ((a + b + c) / 3)[rng.integers(0, n_tris, n_rays)]
    d = np.asarray(jvm.normalize(jnp.asarray(tgt - o)))
    return a, b, c, o, d


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def teapot():
    s = jax_teapot().scene
    return tuple(np.asarray(x) for x in (s.tri_a, s.tri_b, s.tri_c, s.tri_mat))


@pytest.mark.parametrize("ordered", [False, True], ids=["input-order", "bvh-order"])
def test_pack_tri_planes_matches_jax(teapot, ordered):
    a, b, c, m = teapot
    order = np.asarray(jax_build_tri_bvh(a, b, c).prim_order) if ordered else None
    want = jfi.pack_tri_planes(jnp.asarray(a), jnp.asarray(b), jnp.asarray(c), order=order,
                               tri_mat=jnp.asarray(m), const_materials=True)
    got = fi.pack_tri_planes(_t(a), _t(b), _t(c), order=None if order is None else _t(order),
                             tri_mat=_t(m), const_materials=True)
    wp, gp = np.asarray(want.planes), got.planes.numpy()
    assert gp.shape == wp.shape == (18, 50, 128) and got.n_tris == want.n_tris == 6320
    for k in range(18):
        if k in LAYOUT:
            np.testing.assert_array_equal(gp[k], wp[k], err_msg=f"plane {k}")
        else:
            np.testing.assert_allclose(gp[k], wp[k], rtol=0,
                                       atol=2 * EPS32 * np.abs(wp[k]).max(), err_msg=f"plane {k}")
    np.testing.assert_array_equal(got.bounds.numpy(), np.asarray(want.bounds))
    wb = np.asarray(want.bounds)  # the root box: the union of the chunk boxes
    np.testing.assert_array_equal(got.root.numpy(),
                                  np.concatenate([wb[:, 0:3].min(0), wb[:, 3:6].max(0)]))
    wa, ga = np.asarray(want.attrs), got.attrs.numpy()
    np.testing.assert_array_equal(ga[:, 3], wa[:, 3])  # material ids
    np.testing.assert_allclose(ga[:, :3], wa[:, :3], rtol=0, atol=2 * EPS32)
    plain = fi.pack_tri_planes(_t(a), _t(b), _t(c))
    assert plain.attrs is None


def test_ray_chunk_reach_matches_jax(teapot):
    a, b, c, _ = teapot
    planes = jfi.pack_tri_planes(jnp.asarray(a), jnp.asarray(b), jnp.asarray(c))
    rng = np.random.default_rng(5)
    o = (rng.normal(size=(512, 3)) * 4).astype(np.float32)
    d = np.array(jvm.normalize(jnp.asarray(rng.normal(size=(512, 3)).astype(np.float32))))
    d[:16, 0] = 0.0  # axis-parallel rays take the 1e-30 clamp
    cap = rng.uniform(1.0, 12.0, 512).astype(np.float32)
    want = np.asarray(jfi._ray_chunk_reach(planes.bounds, jnp.asarray(o), jnp.asarray(d),
                                           jnp.asarray(cap), T_MIN))
    got = fi.ray_chunk_reach(_t(np.asarray(planes.bounds)), _t(o), _t(d), _t(cap), T_MIN)
    assert 0 < want.sum() < want.size
    np.testing.assert_array_equal(got.numpy(), want)


def _assert_winners_close(got, want, packed=False):
    t, idx, hit, uv = (np.asarray(x) for x in got)
    wt, widx, whit, wuv = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(hit, whit)
    assert hit.sum() > 0
    np.testing.assert_array_equal(idx[hit], widx[hit])
    np.testing.assert_allclose(t[hit], wt[hit], rtol=1e-4)
    np.testing.assert_array_equal(t[~hit], wt[~hit])  # the seed, unchanged
    if not packed:
        np.testing.assert_allclose(uv[hit], wuv[hit], rtol=0, atol=UV_ATOL)


@pytest.mark.parametrize("n_tris", [3, 128, 700])
def test_plain_matches_jax_flash_and_brute(n_tris):
    """Random soups: one partial chunk (125 padding triangles that must
    never win), one full chunk, several chunks."""
    a, b, c, o, d = _soup(1000 + n_tris, n_tris)
    jp = jfi.pack_tri_planes(jnp.asarray(a), jnp.asarray(b), jnp.asarray(c))
    want = jfi.flash_intersect_triangles(jp, jnp.asarray(o), jnp.asarray(d), T_MIN)
    brute = jax_intersect_triangles(jnp.asarray(o), jnp.asarray(d), jnp.asarray(a),
                                    jnp.asarray(b), jnp.asarray(c), T_MIN, 1e30)
    planes = fi.pack_tri_planes(_t(a), _t(b), _t(c))
    got = fi.flash_intersect_plain(planes, _t(o), _t(d), T_MIN)
    _assert_winners_close(got, want)
    _assert_winners_close(got, brute)
    assert (got[1].numpy()[got[2].numpy()] < n_tris).all()
    # the port's brute force agrees with its flash winner exactly (its uv
    # on a miss is that of triangle 0, as in JAX's brute force)
    port_brute = intersect_triangles(_t(o), _t(d), _t(a), _t(b), _t(c), T_MIN, 1e30)
    for x, y in zip(got[:3], port_brute[:3]):
        assert torch.equal(x, y)
    hit = got[2]
    assert torch.equal(got[3][hit], port_brute[3][hit])
    # and JAX's packed planes give the port the same winners
    crossed = fi.flash_intersect_plain(
        tri_planes_from_numpy(np.asarray(jp.planes), np.asarray(jp.bounds), jp.n_tris,
                              device="cpu"), _t(o), _t(d), T_MIN)
    _assert_winners_close(crossed, want)


def test_back_faces_are_culled():
    """tests/test_flash.py's one-sided triangle (triangle.zig:62)."""
    a = np.array([[10.0, 5.0, 1.0]], np.float32)
    b = np.array([[-10.0, -10.0, 1.0]], np.float32)
    c = np.array([[-10.0, 10.0, 1.0]], np.float32)
    planes = fi.pack_tri_planes(_t(a), _t(b), _t(c))
    o = np.tile([[0.0, 0.0, -10.0]], (8, 1)).astype(np.float32)
    d = np.tile([[0.0, 0.0, 1.0]], (8, 1)).astype(np.float32)
    t, idx, hit, _ = fi.flash_intersect_plain(planes, _t(o), _t(d), T_MIN)
    assert bool(hit.all()) and torch.equal(idx, torch.zeros(8, dtype=torch.int32))
    np.testing.assert_allclose(t.numpy(), 11.0, rtol=1e-6)
    _, _, hit2, _ = fi.flash_intersect_plain(planes, _t(-o), _t(-d), T_MIN)
    assert not bool(hit2.any())


@pytest.mark.parametrize("const", [False, True], ids=["orig-ids", "packed-ids"])
def test_t_init_seeding_and_id_modes(const):
    """Seeds from half to twice the true distance, BVH-ordered planes, both
    id modes: against JAX's interpret-mode kernel on the same seeds."""
    a, b, c, o, d = _soup(77, 300, n_rays=256)
    m = np.arange(300, dtype=np.int32) % 3
    order = np.asarray(jax_build_tri_bvh(a, b, c).prim_order)
    jp = jfi.pack_tri_planes(jnp.asarray(a), jnp.asarray(b), jnp.asarray(c), order=order,
                             tri_mat=jnp.asarray(m), const_materials=const)
    base, _, _, _ = jfi.flash_intersect_triangles(jp, jnp.asarray(o), jnp.asarray(d), T_MIN)
    seed = np.where(np.asarray(base) < 1e30, np.asarray(base), 40.0).astype(np.float32)
    seed = seed * np.random.default_rng(3).uniform(0.5, 2.0, 256).astype(np.float32)
    want = jfi.flash_intersect_triangles(jp, jnp.asarray(o), jnp.asarray(d), T_MIN,
                                         t_init=jnp.asarray(seed))
    planes = fi.pack_tri_planes(_t(a), _t(b), _t(c), order=_t(order), tri_mat=_t(m),
                                const_materials=const)
    assert (planes.attrs is not None) == const
    got = fi.flash_intersect_plain(planes, _t(o), _t(d), T_MIN, t_init=_t(seed))
    _assert_winners_close(got, want, packed=const)
    hit = got[2].numpy()
    assert 0 < hit.sum() < 256  # some seeds won
    np.testing.assert_array_equal(got[0].numpy()[~hit], seed[~hit])
    if const:
        assert not got[3].any()
        # packed id p is triangle order[p]: its attrs row holds its material
        packed = got[1].numpy()[hit]
        np.testing.assert_array_equal(planes.attrs[packed, 3].numpy(), m[order[packed]])


def test_dispatch_on_cpu_runs_the_plain_version():
    a, b, c, o, d = _soup(9, 200)
    planes = fi.pack_tri_planes(_t(a), _t(b), _t(c))
    before = counter("launch.flash")
    got = fi.flash_intersect_triangles(planes, _t(o), _t(d), T_MIN)
    want = fi.flash_intersect_plain(planes, _t(o), _t(d), T_MIN)
    assert counter("launch.flash") == before
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    with pytest.raises(ValueError, match="cpu or cuda"):
        fi.flash_intersect_triangles(planes, _t(o).to("meta"), _t(d).to("meta"), T_MIN)


@pytest.mark.parametrize("packed", [False, True], ids=["orig-ids", "packed-ids"])
@pytest.mark.parametrize("case", list(ties.CASES))
def test_tie_cases_match_jax_kernel(case, packed):
    """tests/test_torch_winner_ties.py's flash cases (exact copies in one
    chunk or in two, a hit tied with t_init) through JAX's interpret-mode
    kernel: t and hit equal the plain version's, and so does the id but in
    one case. JAX's original-id mode keeps a best per triangle lane over
    the chunks and takes the lowest lane on a tie (``_kernel_rl``'s
    docstring, "sublane-first"), so of copies in two chunks it returns the
    one in the lower lane; the port, and JAX's packed-id mode, return the
    first in packed order."""
    planes, o, d, t_init, _ = ties.flash_case(case, packed)
    reps = jfi.R_RAYS // len(o)  # the JAX kernel takes whole blocks of rays
    o, d, t_init = o.repeat(reps, 1), d.repeat(reps, 1), t_init.repeat(reps)
    a, b, c = (x.numpy() for x in ties.tie_mesh(*ties.CASES[case]))
    m = np.zeros(len(a), np.int32)
    jp = jfi.pack_tri_planes(jnp.asarray(a), jnp.asarray(b), jnp.asarray(c),
                             tri_mat=jnp.asarray(m) if packed else None, const_materials=packed)
    want = [np.asarray(x) for x in jfi.flash_intersect_triangles(
        jp, jnp.asarray(o.numpy()), jnp.asarray(d.numpy()), T_MIN,
        t_init=jnp.asarray(t_init.numpy()))]
    t, idx, hit, _ = (x.numpy() for x in fi.flash_intersect_plain(planes, o, d, T_MIN, t_init))
    np.testing.assert_array_equal(t, want[0])
    np.testing.assert_array_equal(hit, want[2])
    first, second = ties.CASES[case]
    lower_lane = second if second % fi.LANE < first % fi.LANE else first
    assert hit.sum() == 2 * reps and (idx[hit] == first).all()
    np.testing.assert_array_equal(want[1][hit], first if packed else lower_lane)
    np.testing.assert_array_equal(idx[~hit], want[1][~hit])
