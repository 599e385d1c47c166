"""The port's mesh path against the JAX package, on the CPU: the OBJ
reader, the BVH build, the mesh scenes, the mixed closest-hit query and
the plain mesh wavefront (the CPU engine, and the reference the CUDA
bounce kernel's mesh mode is held to on the card).

Counters must equal JAX's exactly at these sizes, images within
tests/test_pallas3.py's texel-flip bar. The t of a hit is held to 1e-4
relative: XLA's CPU backend contracts the products of the intersection
formulas into fused multiply-adds, the port rounds each one
(tests/test_torch_flash.py).
"""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zraytrace_tpu import camera as jcam
from zraytrace_tpu import vecmath as jvm
from zraytrace_tpu.config import RenderParams as JaxParams
from zraytrace_tpu.geometry.bvh import build_tri_bvh as jax_build_tri_bvh
from zraytrace_tpu.io.obj import ObjParseError as JaxObjParseError
from zraytrace_tpu.io.obj import read_obj as jax_read_obj
from zraytrace_tpu.ops.bounce_kernel3 import wavefront_trace_pallas3
from zraytrace_tpu.ops.flash_intersect import pack_tri_planes as jax_pack_tri_planes
from zraytrace_tpu.render import render as jax_render
from zraytrace_tpu.render import trace_closest as jax_trace_closest
from zraytrace_tpu.render import wavefront_trace as jax_wavefront
from zraytrace_tpu.scene import SceneBuilder as JaxBuilder
from zraytrace_tpu.scene import mesh_materials_const as jax_mesh_const
from zraytrace_tpu.scenes import build_scene as jax_build_scene
from zraytrace_tpu_torch import RenderParams
from zraytrace_tpu_torch.convert import camera_from_numpy, scene_from_numpy
from zraytrace_tpu_torch.geometry.bvh import build_tri_bvh
from zraytrace_tpu_torch.io.obj import ObjParseError, read_obj
from zraytrace_tpu_torch.ops import bounce_kernel as bk
from zraytrace_tpu_torch.profiling import counter
from zraytrace_tpu_torch.render import (
    flash_pack_cached,
    mesh_routing,
    render,
    trace_closest,
    wavefront_trace,
)
from zraytrace_tpu_torch.camera import make_camera
from zraytrace_tpu_torch.scene import SceneBuilder, mesh_materials_const
from zraytrace_tpu_torch.scenes import assets_dir, build_scene

from torch_jax_native import ensure_jax_native, jax_native  # noqa: F401  (an autouse fixture)

torch.set_num_threads(1)

MODELS = ["man/Man.obj", "bunny/bunny.obj", "teapot/teapot.obj"]


def _assert_images_close(sx, sp):
    """tests/test_pallas3.py's bar: rare texel-boundary lanes may differ."""
    diff = np.abs(sx - sp)
    assert (diff > 1e-4).mean() < 0.05, diff.max()
    assert np.median(diff) < 1e-5


def _jax_counters(c) -> list:
    return [int(hi) * (1 << 32) + int(lo) for hi, lo in np.asarray(c)]


def _cross(jscene, jcamera):
    """The JAX scene and camera in the port, through numpy."""
    scene = scene_from_numpy({k: np.asarray(v) for k, v in jscene._asdict().items()}, "cpu")
    return scene, camera_from_numpy(*map(np.asarray, jcamera), device="cpu")


def _pyramid_scene(textured: bool):
    """tests/test_pallas3_mesh.py's mixed scene: ground (image-textured or
    grey), metal and glass spheres, a six-triangle metal pyramid."""
    b = JaxBuilder()
    if textured:
        img = (np.arange(8 * 16 * 3).reshape(8, 16, 3) % 37).astype(np.float32) / 36.0
        ground = b.add_lambertian(b.add_image_texture(img))
    else:
        ground = b.add_lambertian_color((0.5, 0.5, 0.5))
    b.add_sphere((0.0, -100.5, -1.0), 100.0, ground)
    b.add_sphere((-1.2, 0.0, -1.0), 0.5, b.add_metal_color((0.8, 0.6, 0.2)))
    b.add_sphere((0.0, 0.0, -0.6), 0.3, b.add_dielectric(1.5))
    cx, cy, cz, half = 1.0, -0.4, -1.0, 0.4
    bp = [(cx - half, cy, cz + half), (cx + half, cy, cz + half),
          (cx + half, cy, cz - half), (cx - half, cy, cz - half)]
    tris = [(bp[i], bp[(i + 1) % 4], (cx, 0.8, cz)) for i in range(4)]
    tris += [(bp[0], bp[2], bp[1]), (bp[0], bp[3], bp[2])]
    a, bb, c = (np.array([t[k] for t in tris], np.float32) for k in range(3))
    b.add_triangles(a, bb, c, b.add_metal_color((0.9, 0.9, 0.9)))
    camera = jcam.make_camera((0, 0.5, 2.0), (0.3, 0, -1), (0, 1, 0), 60.0, 1.0)
    return b.build(), camera


@pytest.fixture(scope="module")
def jax_teapot():
    return jax_build_scene(3)


@pytest.mark.parametrize("model", MODELS)
def test_read_obj_matches_jax(model):
    path = assets_dir() / model
    want, got = jax_read_obj(path), read_obj(path)
    np.testing.assert_array_equal(got.vertices, want.vertices)
    np.testing.assert_array_equal(got.triangles, want.triangles)
    assert got.faces == want.faces
    assert got.n_normals == want.vertex_normals.shape[0]
    for x, y in zip(got.tri_vertices, want.tri_vertices):
        np.testing.assert_array_equal(x, y)


def test_obj_fan_pattern_tokens_and_errors(tmp_path):
    """Quads to hexagons fan as {0,1,2} {2,3,0} {3,4,0} {4,5,0}; v, v/t,
    v/t/n and v//n tokens; 1-based indices; faces of 2 or 7 vertices raise
    in both packages; a missing file raises FileNotFoundError."""
    verts = "".join(f"v {i} {i * 0.5} {-i}\n" for i in range(1, 8))
    good = tmp_path / "good.obj"
    good.write_text(verts + "vn 0 1 0\nf 1 2 3\nf 1/1 2/2 3/3 4/4\n"
                    "f 1/1/1 2/2/1 3/3/1 4/4/1 5/5/1\nf 1//1 2//1 3//1 4//1 5//1 6//1\n")
    want, got = jax_read_obj(good), read_obj(good)
    np.testing.assert_array_equal(got.triangles, want.triangles)
    np.testing.assert_array_equal(got.vertices, want.vertices)
    assert got.faces == want.faces == 4
    assert got.n_normals == want.vertex_normals.shape[0] == 1
    assert got.triangles[1:3].tolist() == [[0, 1, 2], [2, 3, 0]]
    for n in (2, 7):
        bad = tmp_path / f"bad{n}.obj"
        bad.write_text(verts + "f " + " ".join(str(i + 1) for i in range(n)) + "\n")
        with pytest.raises(JaxObjParseError):
            jax_read_obj(bad)
        with pytest.raises(ObjParseError):
            read_obj(bad)
    with pytest.raises(FileNotFoundError):
        read_obj(tmp_path / "absent.obj")


@pytest.mark.parametrize("index", [0, 2, 3])
def test_bvh_matches_jax(index):
    """The port's copy of the C++ builder gives the JAX package's tree:
    prim_order (and so packed ids) bit for bit, and the node count."""
    s = jax_build_scene(index).scene
    want = jax_build_tri_bvh(s.tri_a, s.tri_b, s.tri_c)
    got = build_tri_bvh(*(torch.from_numpy(np.array(x)) for x in (s.tri_a, s.tri_b, s.tri_c)))
    np.testing.assert_array_equal(got.prim_order.numpy(), np.asarray(want.prim_order))
    assert got.n_nodes == want.n_nodes


def test_jax_native_replaces_a_failed_load(monkeypatch, tmp_path):
    """A process whose first load of the JAX package's library failed (the
    cached file still being written by another process's g++) builds its
    BVHs with the numpy fallback, whose scene 3 ``prim_order`` is not the
    port's; ``ensure_jax_native`` installs a private build in its place,
    and the orders agree again."""
    from zraytrace_tpu.native import api as jax_native_api
    from zraytrace_tpu.native import build as jax_native_build

    s = jax_build_scene(3).scene
    monkeypatch.setenv("ZRAYTRACE_NATIVE_CACHE", str(tmp_path))
    monkeypatch.setattr(jax_native_build, "_LIB", None)
    monkeypatch.setattr(jax_native_build, "_TRIED", False)
    monkeypatch.setattr(jax_native_api, "_sig_done", False)
    srcs = [jax_native_build._src_dir() / name for name in jax_native_build._SOURCES]
    digest = hashlib.sha256(b"".join(p.read_bytes() for p in srcs)).hexdigest()[:16]
    (tmp_path / f"libzrt_{digest}.so").write_bytes(b"\x7fELF")  # a half-written library
    assert jax_native_build.load_library() is None
    ensure_jax_native()
    want = jax_build_tri_bvh(s.tri_a, s.tri_b, s.tri_c)
    got = build_tri_bvh(*(torch.from_numpy(np.array(x)) for x in (s.tri_a, s.tri_b, s.tri_c)))
    np.testing.assert_array_equal(got.prim_order.numpy(), np.asarray(want.prim_order))


@pytest.mark.parametrize("index", [0, 2, 3, 4])
def test_mesh_scene_fields_match_jax(index):
    """All 16 fields exact; the f32 camera frame within an ulp (tan and
    normalize may round differently)."""
    jb = jax_build_scene(index)
    tb = build_scene(index, "cpu")
    assert tb.name == jb.name
    for name, jv in jb.scene._asdict().items():
        want = np.asarray(jv)
        got = getattr(tb.scene, name).numpy()
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    for jv, tv in zip(jb.camera, tb.camera):
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6, atol=1e-7)
    assert mesh_materials_const(tb.scene) == jax_mesh_const(jb.scene) is True


def test_mesh_materials_const_matches_jax():
    for textured in (False, True):
        js, _ = _pyramid_scene(textured)
        scene, _ = _cross(js, jcam.make_camera((0, 0, 1), (0, 0, 0), (0, 1, 0), 45.0, 1.0))
        assert mesh_materials_const(scene) == jax_mesh_const(js) is True
    three = build_scene(1, "cpu").scene  # no triangles
    assert mesh_materials_const(three) is False


def _rays(n, seed, target):
    """Origins around the scene, half the rays aimed at ``target`` points
    (triangle centroids: rays aimed at vertices would graze the edges,
    where the two roundings may disagree on the hit)."""
    r = np.random.default_rng(seed)
    o = (r.normal(size=(n, 3)) * [3.0, 2.0, 3.0] + [0.0, 0.5, 0.0]).astype(np.float32)
    tgt = target[r.integers(0, len(target), n)]
    d = np.where(np.arange(n)[:, None] % 2 == 0, tgt - o, r.normal(size=(n, 3)))
    return o, np.array(jvm.normalize(jnp.asarray(d.astype(np.float32))))


@pytest.mark.parametrize("case", ["pyramid", "teapot-circle"])
def test_trace_closest_mixed_matches_jax(case):
    """The mixed branch, spheres then brute triangles merged by strict <:
    hit, mat_id and front face exact, t relative 1e-4, normals 1e-5; and
    the flash-attrs branch (plain flash winner, attrs normal and material)
    gives the port's brute branch exactly."""
    if case == "pyramid":
        js, jc = _pyramid_scene(textured=True)
    else:
        jb = jax_build_scene(4)
        js, jc = jb.scene, jb.camera
    scene, _ = _cross(js, jc)
    centroids = (np.asarray(js.tri_a) + np.asarray(js.tri_b) + np.asarray(js.tri_c)) / 3
    o, d = _rays(1024, 11, centroids)
    want = jax_trace_closest(js, jnp.asarray(o), jnp.asarray(d))
    got = trace_closest(scene, torch.from_numpy(o), torch.from_numpy(d))
    hit = np.asarray(want["hit"])
    np.testing.assert_array_equal(got["hit"].numpy(), hit)
    assert 0 < hit.sum() < len(hit)
    for k in ("mat_id", "front_face"):
        np.testing.assert_array_equal(got[k].numpy()[hit], np.asarray(want[k])[hit], err_msg=k)
    np.testing.assert_allclose(got["t"].numpy()[hit], np.asarray(want["t"])[hit], rtol=1e-4)
    np.testing.assert_allclose(got["normal"].numpy()[hit], np.asarray(want["normal"])[hit],
                               atol=1e-5)
    planes = flash_pack_cached(scene)
    assert planes.attrs is not None
    flash = trace_closest(scene, torch.from_numpy(o), torch.from_numpy(d), tri_flash=planes)
    for k in ("hit", "t", "mat_id", "front_face", "normal", "point"):
        assert torch.equal(flash[k][got["hit"]], got[k][got["hit"]]), k


@pytest.fixture(scope="module")
def pyramid_run():
    """Plain mesh wavefront on the untextured pyramid, 16x16 spp 2 depth 6."""
    js, jc = _pyramid_scene(textured=False)
    scene, camera = _cross(js, jc)
    base = torch.arange(256, dtype=torch.int32)
    sums, counters = wavefront_trace(scene, camera, base, 42, 16, 16, 2, 6, 0, 256, 256, 1)
    return js, jc, scene, camera, sums.numpy(), counters.tolist()


def test_plain_mesh_wavefront_matches_jax_pyramid(pyramid_run):
    js, jc, _, _, sums, counters = pyramid_run
    sx, cx = jax_wavefront(js, jc, jnp.arange(256, dtype=jnp.int32), 42, 16, 16, 2, 6, 0,
                           None, 256, 256, 1)
    assert counters == _jax_counters(cx)  # all six
    assert counters[4] == 16 * 16 * 2 and counters[1] > 0
    _assert_images_close(np.asarray(sx), sums)


def test_plain_mesh_wavefront_matches_pallas3_interpret(pyramid_run):
    """The TPU kernel's mesh mode (deferred mesh hits resolved by the flash
    kernel), run in interpret mode as tests/test_pallas3_mesh.py runs it."""
    js, jc, _, _, sums, counters = pyramid_run
    order = jax_build_tri_bvh(js.tri_a, js.tri_b, js.tri_c).prim_order
    tf = jax_pack_tri_planes(js.tri_a, js.tri_b, js.tri_c, order=order, tri_mat=js.tri_mat,
                             const_materials=True)
    sp, cp = wavefront_trace_pallas3(js, jc, jnp.arange(256, dtype=jnp.int32), 42, 16, 16, 2,
                                     6, 0, 1, 256, 256, n_bounce=6, tri_flash=tf)
    assert counters[:5] == _jax_counters(cp)[:5]
    np.testing.assert_allclose(np.asarray(sp), sums, atol=1e-5)


@pytest.fixture(scope="module")
def teapot_run(jax_teapot):
    """Scene 3 cut to 16x16 pixels, spp 2, depth 4."""
    scene, camera = _cross(jax_teapot.scene, jax_teapot.camera)
    base = torch.arange(256, dtype=torch.int32)
    sums, counters = wavefront_trace(scene, camera, base, 42, 16, 16, 2, 4, 0, 256, 256, 1)
    return scene, camera, sums.numpy(), counters.tolist()


def test_plain_mesh_wavefront_matches_jax_teapot(jax_teapot, teapot_run):
    _, _, sums, counters = teapot_run
    sx, cx = jax_wavefront(jax_teapot.scene, jax_teapot.camera, jnp.arange(256, dtype=jnp.int32),
                           42, 16, 16, 2, 4, 0, None, 256, 256, 1)
    assert counters == _jax_counters(cx)
    assert counters[1] > 0  # the teapot reflects
    _assert_images_close(np.asarray(sx), sums)


def test_flash_route_equals_brute_route(teapot_run):
    """The plain wavefront over BVH-ordered flash planes (the bounce
    kernel's reference on the card) gives the brute-force route's counters
    and sums exactly on scene 3."""
    scene, camera, sums, counters = teapot_run
    planes = flash_pack_cached(scene)
    fs, fc = wavefront_trace(scene, camera, torch.arange(256, dtype=torch.int32), 42, 16, 16,
                             2, 4, 0, 256, 256, 1, tri_flash=planes)
    assert fc.tolist() == counters
    np.testing.assert_array_equal(fs.numpy(), sums)


def test_bounce_trace_mesh_on_cpu_runs_the_plain_version(teapot_run):
    scene, camera, sums, counters = teapot_run
    names = ("launch.bounce", "launch.bounce_mesh", "launch.flash")
    before = [counter(k) for k in names]
    base = torch.arange(256, dtype=torch.int32)
    for planes in (None, flash_pack_cached(scene)):
        s, c = bk.bounce_trace(scene, camera, base, 42, 16, 16, 2, 4, 0, 256, 256, 1,
                               tri_flash=planes)
        assert c.tolist() == counters
        np.testing.assert_array_equal(s.numpy(), sums)
    assert [counter(k) for k in names] == before


def test_render_mesh_matches_jax_render(jax_teapot):
    """render() on the CPU takes the brute-force route, as the JAX
    package's render() does off the TPU."""
    scene, camera = _cross(jax_teapot.scene, jax_teapot.camera)
    assert mesh_routing(scene, "cpu") == (True, None)
    jimg, jst = jax_render(jax_teapot.scene, jax_teapot.camera,
                           JaxParams(width=20, height=12, samples_per_pixel=2, max_depth=4,
                                     use_pallas=False))
    img, st = render(scene, camera, RenderParams(20, 12, 2, 4), "cpu")
    for k in ("rays", "reflections", "background_hits", "recursion_depth_hits",
              "samples", "pixels", "wavefront_iterations"):
        assert getattr(st, k) == getattr(jst, k), k
    _assert_images_close(np.asarray(jimg), img.numpy())


def test_flash_pack_cached_memoizes(teapot_run):
    scene = teapot_run[0]
    planes = flash_pack_cached(scene)
    assert flash_pack_cached(scene) is planes
    assert planes.n_tris == 6320 and planes.n_chunks == 50
    assert planes.attrs.shape == (50 * 128, 4)


def test_cuda_mesh_mode_refuses_a_textured_mesh(teapot_run):
    """The bounce kernel's mesh mode shades from the const-material attrs
    table. A mesh with an image-textured material has none: the check the
    kernel's wrapper runs before it launches raises and says that
    ``render()`` routes around it (``render.mesh_routing`` sends such a
    mesh to the wavefront with the flash winner on the card), while the
    CPU path renders the scene through the brute force."""
    b = SceneBuilder()
    img = (np.arange(4 * 8 * 3).reshape(4, 8, 3) % 7).astype(np.float32) / 6.0
    b.add_sphere((0.0, -100.5, -1.0), 100.0, b.add_lambertian_color((0.5, 0.5, 0.5)))
    a, bb, c = (np.array([p], np.float32) for p in ((-1, -0.5, -1), (1, -0.5, -1), (0, 1, -1)))
    b.add_triangles(a, bb, c, b.add_lambertian(b.add_image_texture(img)))
    scene = b.build("cpu")
    assert not mesh_materials_const(scene)
    planes = flash_pack_cached(scene)
    assert planes.attrs is None
    for tf in (planes, None):
        with pytest.raises(NotImplementedError, match="render.mesh_routing sends a mesh"):
            bk.check_mesh(scene, tf)
    teapot = teapot_run[0]
    bk.check_mesh(teapot, flash_pack_cached(teapot))  # const materials pass
    camera = make_camera((0, 0, 1), (0, 0, -1), (0, 1, 0), 60.0, 1.0, device="cpu")
    img, st = render(scene, camera, RenderParams(8, 8, 1, 3), "cpu")
    assert bool(torch.isfinite(img).all()) and st.samples == 64
