"""Sphere intersection, hit attributes and material scatter of the
PyTorch port against the JAX functions, on seeded rays through scene 1."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zraytrace_tpu import materials as jmat
from zraytrace_tpu import vecmath as jvm
from zraytrace_tpu.geometry import sphere as jsph
from zraytrace_tpu.render import trace_closest as jax_trace_closest
from zraytrace_tpu.scenes import three_balls as jax_three_balls
from zraytrace_tpu_torch import materials as tmat
from zraytrace_tpu_torch import vecmath as tvm
from zraytrace_tpu_torch.convert import scene_from_numpy
from zraytrace_tpu_torch.geometry import sphere as tsph
from zraytrace_tpu_torch.render import trace_closest

torch.set_num_threads(1)

N = 20000
T_MIN = 1e-3


@pytest.fixture(scope="module")
def scenes():
    jb = jax_three_balls()
    return jb.scene, scene_from_numpy({k: np.asarray(v) for k, v in jb.scene._asdict().items()},
                                       "cpu")


@pytest.fixture(scope="module")
def rays():
    """Origins around the scene and unit directions (normalized in f32 by
    the JAX function, so both sides start from identical rays)."""
    r = np.random.default_rng(2024)
    o = (r.normal(size=(N, 3)) * np.array([3.0, 2.0, 4.0]) + [0.0, 0.0, 2.0]).astype(np.float32)
    o[: N // 4] = [0.0, 0.0, -7.0]  # a quarter from the camera
    d = np.array(jvm.normalize(jnp.asarray(r.normal(size=(N, 3)).astype(np.float32))))
    d[: N // 4, 2] = np.abs(d[: N // 4, 2])
    d = np.array(jvm.normalize(jnp.asarray(d)))
    return o, d


def test_intersect_spheres_fused_matches_jax(scenes, rays):
    """hit and mat_id exact. The JAX function computes ``d @ c`` and
    ``o @ c`` as XLA's CPU matvec does, a fused multiply-add chain
    ``fma(dz, cz, fma(dy, cy, dx*cx))``; the port sums separately rounded
    products, as the CUDA kernel does. The cancellation line
    ``|o|^2 - 2 o.c + (c.c - r^2)`` (r = 100 for the ground) turns that
    last-bit difference into up to 3.1e-5 in t on this ray set, so t is
    held to 5e-5 absolute, and to rtol 1e-6 on at least 95% of hits
    (96.7% here)."""
    js, ts = scenes
    o, d = rays
    want = jsph.intersect_spheres_fused(jnp.asarray(o), jnp.asarray(d), js.sph_center,
                                        js.sph_radius, js.sph_mat, T_MIN, tsph.BIG)
    got = tsph.intersect_spheres_fused(torch.from_numpy(o), torch.from_numpy(d),
                                       ts.sph_center, ts.sph_radius, ts.sph_mat,
                                       T_MIN, tsph.BIG)
    np.testing.assert_array_equal(got["hit"].numpy(), np.asarray(want["hit"]))
    np.testing.assert_array_equal(got["mat_id"].numpy(), np.asarray(want["mat_id"]))
    t, t_want = got["t"].numpy(), np.asarray(want["t"])
    np.testing.assert_allclose(t, t_want, rtol=0, atol=5e-5)
    hit = got["hit"].numpy()
    assert (np.abs(t - t_want)[hit] <= 1e-6 * t_want[hit]).mean() > 0.95
    np.testing.assert_array_equal(got["radius"].numpy(), np.asarray(want["radius"]))
    assert 0.2 < hit.mean() < 0.9  # both hits and misses are exercised


def test_ground_sphere_no_phantom_hits(scenes):
    """Rays from the camera pointing up can never reach the r=100 ground
    sphere: the catastrophic-cancellation line must not invent hits."""
    _, ts = scenes
    r = np.random.default_rng(9)
    d = r.normal(size=(5000, 3)).astype(np.float32)
    d[:, 1] = np.abs(d[:, 1]) + 0.05
    d = tvm.normalize(torch.from_numpy(d))
    o = torch.tensor([[0.0, 0.0, -7.0]]).expand(5000, 3)
    got = tsph.intersect_spheres_fused(o, d, ts.sph_center[:1], ts.sph_radius[:1],
                                       ts.sph_mat[:1], T_MIN, tsph.BIG)
    assert not bool(got["hit"].any())


def test_sphere_attributes_match_jax(scenes, rays):
    """Point and normal within 1e-5; uv within 1e-5 (XLA's and torch's
    acos/atan2 differ in the last ulp)."""
    js, ts = scenes
    o, d = rays
    fs = tsph.intersect_spheres_fused(torch.from_numpy(o), torch.from_numpy(d),
                                      ts.sph_center, ts.sph_radius, ts.sph_mat,
                                      T_MIN, tsph.BIG)
    t = torch.where(fs["hit"], fs["t"], 1.0)
    args = (o, d, t.numpy(), fs["center"].numpy(), fs["radius"].numpy())
    want = jsph.sphere_attributes(*map(jnp.asarray, args))
    got = tsph.sphere_attributes(*map(torch.from_numpy, args))
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-5)


def test_safe_radius_and_hollow_sphere():
    """A negative radius gives inward normals; a zero radius stays finite
    with its sign."""
    o = torch.tensor([[0.0, 0.0, -5.0]] * 3)
    d = torch.tensor([[0.0, 0.0, 1.0]] * 3)
    t = torch.tensor([4.0, 4.0, 4.0])
    center = torch.zeros(3, 3)
    radius = torch.tensor([1.0, -1.0, 0.0])
    _, normal, uv = tsph.sphere_attributes(o, d, t, center, radius)
    assert normal[0, 2] == -1.0 and normal[1, 2] == 1.0
    assert bool(torch.isfinite(normal).all()) and bool(torch.isfinite(uv).all())


def test_trace_closest_matches_jax(scenes, rays):
    js, ts = scenes
    o, d = rays
    want = jax_trace_closest(js, jnp.asarray(o), jnp.asarray(d))
    got = trace_closest(ts, torch.from_numpy(o), torch.from_numpy(d))
    for k in ("hit", "front_face", "mat_id"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    # the t difference above moves the hit point along the ray by <= 5e-5
    hit = got["hit"].numpy()
    for k in ("point", "normal"):
        np.testing.assert_allclose(got[k].numpy()[hit], np.asarray(want[k])[hit],
                                   rtol=0, atol=5e-5, err_msg=k)


def test_scatter_matches_jax(scenes, rays):
    """On the hit lanes: ``absorbed`` exact, new directions within 1e-5
    (XLA's rsqrt and cos/sin differ from torch's in the last ulp), and the
    attenuation equal except on texel-boundary lanes, where the two
    backends' acos/atan2 may pick the neighbouring texel (at most 0.5%)."""
    js, ts = scenes
    o, d = rays
    h = trace_closest(ts, torch.from_numpy(o), torch.from_numpy(d))
    hit = h["hit"].numpy()
    r = np.random.default_rng(77)
    rnd = r.random((N, 4), dtype=np.float32)
    normal, front, uv, mid = (h[k].numpy() for k in ("normal", "front_face", "uv", "mat_id"))
    want = jmat.scatter(js, jnp.asarray(d), jnp.asarray(normal), jnp.asarray(front),
                        jnp.asarray(uv), jnp.asarray(mid), jnp.asarray(rnd))
    got = tmat.scatter(ts, torch.from_numpy(d), torch.from_numpy(normal),
                       torch.from_numpy(front), torch.from_numpy(uv),
                       torch.from_numpy(mid), torch.from_numpy(rnd))
    wd, wa, wab = (np.asarray(x)[hit] for x in want)
    gd, ga, gab = (x.numpy()[hit] for x in got)
    np.testing.assert_array_equal(gab, wab)
    np.testing.assert_allclose(gd, wd, rtol=0, atol=1e-5)
    same = (ga == wa).all(axis=-1)
    assert same.mean() > 0.995, same.mean()
    # every material class is exercised
    types = ts.mat_type[h["mat_id"][torch.from_numpy(hit)].long()]
    assert set(types.tolist()) == {0, 1, 2}


def test_schlick_and_refract_match_jax():
    r = np.random.default_rng(5)
    cos = r.random(1000, dtype=np.float32)
    ratio = (r.random(1000, dtype=np.float32) + 0.3).astype(np.float32)
    np.testing.assert_array_equal(
        tmat.schlick_reflectance(torch.from_numpy(cos), torch.from_numpy(ratio)).numpy(),
        np.asarray(jmat.schlick_reflectance(jnp.asarray(cos), jnp.asarray(ratio))))
    v = np.array(jvm.normalize(jnp.asarray(r.normal(size=(1000, 3)).astype(np.float32))))
    n = np.array(jvm.normalize(jnp.asarray(r.normal(size=(1000, 3)).astype(np.float32))))
    want = np.asarray(jvm.refract(jnp.asarray(v), jnp.asarray(n), jnp.asarray(ratio)))
    got = tvm.refract(torch.from_numpy(v), torch.from_numpy(n), torch.from_numpy(ratio))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    assert bool(torch.isfinite(got).all())
