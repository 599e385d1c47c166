"""The port's checkpoints (``zraytrace_tpu_torch/checkpoint.py`` and
``inverse.fit(checkpoint_path=)``) on the CPU: the counterparts of the
cases of tests/test_checkpoint.py that run off the TPU, and the port's
checkpointed render against the JAX package's on the same scene.

The sharded case starts four gloo ranks (``multihost.run_ranks``, spawn);
they import the port and numpy only. JAX is imported inside the tests.
"""

import numpy as np
import pytest
import torch

from zraytrace_tpu_torch import RenderParams
from zraytrace_tpu_torch import checkpoint as ck
from zraytrace_tpu_torch.checkpoint import (
    RenderCheckpoint,
    load_checkpoint,
    render_checkpointed,
    save_checkpoint,
)
from zraytrace_tpu_torch.convert import camera_from_numpy, scene_from_numpy

torch.set_num_threads(1)


def _numpy_scene(jscene, jcam):
    return {k: np.asarray(v) for k, v in jscene._asdict().items()}, list(map(np.asarray, jcam))


def _cross(fields, cam):
    return scene_from_numpy(fields, "cpu"), camera_from_numpy(*cam, device="cpu")


@pytest.fixture(scope="module")
def mini():
    """The JAX tests' mini scene (three spheres and a glass ball), as
    numpy arrays and in both packages."""
    from test_render import _mini_scene

    jscene, jcam = _mini_scene()
    fields, cam = _numpy_scene(jscene, jcam)
    return (jscene, jcam), fields, cam


@pytest.fixture(scope="module")
def balls():
    from zraytrace_tpu.scenes import three_balls

    jb = three_balls()
    fields, cam = _numpy_scene(jb.scene, jb.camera)
    return (jb.scene, jb.camera), fields, cam


def _counters(st):
    return [st.rays, st.reflections, st.background_hits, st.recursion_depth_hits, st.samples]


def test_save_load_roundtrip(tmp_path):
    c = RenderCheckpoint(pixel_sum=np.random.default_rng(0).random((16, 3)),
                         counters=np.arange(6, dtype=np.int64) * (1 << 40), samples_done=7,
                         width=4, height=4, seed=42, max_depth=5, scene_hash="abc")
    p = tmp_path / "ck.npz"
    save_checkpoint(p, c)
    back = load_checkpoint(p)
    np.testing.assert_array_equal(back.pixel_sum, c.pixel_sum)
    np.testing.assert_array_equal(back.counters, c.counters)
    assert (back.samples_done, back.seed, back.scene_hash) == (7, 42, "abc")
    assert [f.name for f in tmp_path.iterdir()] == ["ck.npz"]  # no temporary file left
    assert load_checkpoint(tmp_path / "none.npz") is None


def test_resume_bit_identical(tmp_path, mini):
    _, fields, cam = mini
    scene, camera = _cross(fields, cam)
    params = RenderParams(width=8, height=8, samples_per_pixel=6, max_depth=4)
    img_full, st_full = render_checkpointed(scene, camera, params, tmp_path / "a.npz",
                                            chunk_spp=2, device="cpu")
    p2 = tmp_path / "b.npz"
    render_checkpointed(scene, camera, RenderParams(width=8, height=8, samples_per_pixel=2,
                                                    max_depth=4), p2, chunk_spp=2, device="cpu")
    assert load_checkpoint(p2).samples_done == 2
    img_res, st_res = render_checkpointed(scene, camera, params, p2, chunk_spp=2, device="cpu")
    assert torch.equal(img_full, img_res)
    assert _counters(st_full) == _counters(st_res)
    assert st_res.samples == 8 * 8 * 6


def test_mismatched_config_rejected(tmp_path, mini):
    _, fields, cam = mini
    scene, camera = _cross(fields, cam)
    p = tmp_path / "ck.npz"
    render_checkpointed(scene, camera, RenderParams(width=8, height=8, samples_per_pixel=2,
                                                    max_depth=4), p, chunk_spp=2, device="cpu")
    with pytest.raises(ValueError, match="render config"):
        render_checkpointed(scene, camera, RenderParams(width=8, height=8, samples_per_pixel=4,
                                                        max_depth=3), p, device="cpu")


def test_checkpoint_rejects_engine_and_chunking_switch(tmp_path, balls, monkeypatch):
    """The fingerprint covers the engine and the chunking: a CPU-engine
    checkpoint refuses to resume on the kernel's engine, and any
    checkpoint refuses another chunk size."""
    _, fields, cam = balls
    scene, camera = _cross(fields, cam)
    p = tmp_path / "ck.npz"
    render_checkpointed(scene, camera, RenderParams(width=16, height=16, samples_per_pixel=2,
                                                    max_depth=3), p, chunk_spp=2, device="cpu")
    params = RenderParams(width=16, height=16, samples_per_pixel=4, max_depth=3)
    with pytest.raises(ValueError, match="different scene"):
        render_checkpointed(scene, camera, params, p, chunk_spp=1, device="cpu")
    monkeypatch.setattr(ck, "_engine", lambda device: "cuda")
    with pytest.raises(ValueError, match="different scene"):
        render_checkpointed(scene, camera, params, p, chunk_spp=2, device="cpu")


def test_jax_checkpoint_refused_by_magic(tmp_path, mini):
    """A file the JAX package wrote is not this package's checkpoint."""
    from zraytrace_tpu.checkpoint import RenderCheckpoint as JaxCheckpoint
    from zraytrace_tpu.checkpoint import save_checkpoint as jax_save

    p = tmp_path / "jax.npz"
    jax_save(p, JaxCheckpoint(pixel_sum=np.zeros((64, 3)), counters=np.zeros((6, 2), np.uint64),
                              samples_done=2, width=8, height=8, seed=42, max_depth=4))
    with pytest.raises(ValueError, match="zraytrace_tpu_torch-render-v1"):
        load_checkpoint(p)
    _, fields, cam = mini
    scene, camera = _cross(fields, cam)
    with pytest.raises(ValueError, match="not a"):
        render_checkpointed(scene, camera, RenderParams(width=8, height=8, samples_per_pixel=4,
                                                        max_depth=4), p, device="cpu")


def test_checkpointed_resume_and_render_counters(tmp_path, balls):
    """Resume bit for bit; counters equal ``render()``'s, the image within
    tests/test_checkpoint.py's bar (only the order of the adds differs)."""
    from zraytrace_tpu_torch.render import render

    _, fields, cam = balls
    scene, camera = _cross(fields, cam)
    params = RenderParams(width=16, height=16, samples_per_pixel=6, max_depth=3)
    p1, p2 = tmp_path / "a.npz", tmp_path / "b.npz"
    img_full, st_full = render_checkpointed(scene, camera, params, p1, chunk_spp=2, device="cpu")
    render_checkpointed(scene, camera, RenderParams(width=16, height=16, samples_per_pixel=2,
                                                    max_depth=3), p2, chunk_spp=2, device="cpu")
    img_res, st_res = render_checkpointed(scene, camera, params, p2, chunk_spp=2, device="cpu")
    assert torch.equal(img_full, img_res) and _counters(st_full) == _counters(st_res)
    img_r, st_r = render(scene, camera, params, device="cpu")
    assert _counters(st_r) == _counters(st_full)
    np.testing.assert_allclose(img_full.numpy(), img_r.numpy(), rtol=2e-5, atol=2e-6)


def test_checkpointed_mesh_resume(tmp_path):
    """A scene with spheres and a triangle: resume bit for bit, counters
    equal ``render()``'s."""
    from zraytrace_tpu_torch.camera import make_camera
    from zraytrace_tpu_torch.render import render
    from zraytrace_tpu_torch.scene import SceneBuilder

    b = SceneBuilder()
    b.add_sphere((0.0, -100.5, -1.0), 100.0, b.add_lambertian_color((0.5, 0.5, 0.5)))
    b.add_sphere((-1.2, 0.0, -1.0), 0.5, b.add_metal_color((0.8, 0.6, 0.2)))
    tri = np.asarray([[[1.0, -0.4, -1.0]], [[1.6, -0.4, -1.0]], [[1.3, 0.5, -1.0]]], np.float32)
    b.add_triangles(tri[0], tri[1], tri[2], b.add_metal_color((0.9, 0.9, 0.9)))
    scene = b.build("cpu")
    camera = make_camera((0, 0.5, 2.0), (0.3, 0, -1), (0, 1, 0), 60.0, 1.0, device="cpu")
    params = RenderParams(width=16, height=16, samples_per_pixel=4, max_depth=3)
    p1, p2 = tmp_path / "a.npz", tmp_path / "b.npz"
    img_full, st_full = render_checkpointed(scene, camera, params, p1, chunk_spp=2, device="cpu")
    render_checkpointed(scene, camera, RenderParams(width=16, height=16, samples_per_pixel=2,
                                                    max_depth=3), p2, chunk_spp=2, device="cpu")
    img_res, st_res = render_checkpointed(scene, camera, params, p2, chunk_spp=2, device="cpu")
    assert torch.equal(img_full, img_res) and _counters(st_full) == _counters(st_res)
    _, st_r = render(scene, camera, params, device="cpu")
    assert _counters(st_r) == _counters(st_full)


@pytest.mark.parametrize("which", ["mini", "balls"])
def test_checkpointed_matches_jax(tmp_path, which, mini, balls):
    """The port's checkpointed render against JAX's on the XLA engine,
    from the same arrays: counters exact, image within 1e-5."""
    from zraytrace_tpu.checkpoint import render_checkpointed as jax_render_checkpointed
    from zraytrace_tpu.config import RenderParams as JaxParams

    (jscene, jcam), fields, cam = mini if which == "mini" else balls
    w, h, spp, depth = 16, 16, 8, 3
    want_img, want = jax_render_checkpointed(
        jscene, jcam, JaxParams(width=w, height=h, samples_per_pixel=spp, max_depth=depth,
                                use_pallas=False), tmp_path / "jax.npz", chunk_spp=4)
    scene, camera = _cross(fields, cam)
    got_img, got = render_checkpointed(scene, camera, RenderParams(
        width=w, height=h, samples_per_pixel=spp, max_depth=depth), tmp_path / "torch.npz",
        chunk_spp=4, device="cpu")
    assert _counters(got) == _counters(want)
    np.testing.assert_allclose(got_img.numpy(), np.asarray(want_img), atol=1e-5, rtol=0)


def _fit_setup():
    from test_render import _mini_scene

    from zraytrace_tpu_torch.inverse import merge_scene, split_scene
    from zraytrace_tpu_torch.render_diff import render_diff

    scene, camera = _cross(*_numpy_scene(*_mini_scene()))
    with torch.no_grad():
        target = render_diff(scene, camera, 8, 8, spp=2, max_depth=2, seed=7)
    params, static = split_scene(scene)
    start = merge_scene({**params, "sph_radius": params["sph_radius"] * 1.05}, static)
    return start, camera, target


FIT_KW = dict(width=8, height=8, spp=2, max_depth=2, steps=4, learning_rate=1e-2,
              optimize_fields=("sph_radius",), device="cpu")


def test_fit_checkpoint_resume_bitexact(tmp_path):
    """A fit cut after 2 steps and resumed to 4 equals the uninterrupted
    fit bit for bit, losses and parameters; the file restores the
    parameters and Adam's moments bit for bit."""
    from zraytrace_tpu_torch.checkpoint import load_fit_checkpoint, save_fit_checkpoint
    from zraytrace_tpu_torch.inverse import fit

    start, camera, target = _fit_setup()
    p = str(tmp_path / "fit.npz")
    full = fit(start, camera, target, **FIT_KW)
    fit(start, camera, target, checkpoint_path=p, checkpoint_every=2, **{**FIT_KW, "steps": 2})
    with np.load(p) as z:
        saved = {k: z[k].copy() for k in z.files}
    assert int(saved["step"]) == 2 and saved["losses"].shape == (2,)
    # restore into fresh tensors and an optimizer, write again: the same arrays
    x = start.sph_radius.clone().requires_grad_(True)
    opt = torch.optim.Adam([x], lr=1e-2)
    step, _ = load_fit_checkpoint(p, {"sph_radius": x}, opt, str(saved["fingerprint"]))
    assert step == 2
    save_fit_checkpoint(tmp_path / "again.npz", {"sph_radius": x}, opt, step, saved["losses"],
                        str(saved["fingerprint"]))
    with np.load(tmp_path / "again.npz") as z:
        for k, v in saved.items():
            np.testing.assert_array_equal(z[k], v, err_msg=k)
    resumed = fit(start, camera, target, checkpoint_path=p, checkpoint_every=2, **FIT_KW)
    assert torch.equal(full.scene.sph_radius, resumed.scene.sph_radius)
    assert torch.equal(full.losses, resumed.losses)


def test_fit_checkpoint_rejects_config_change(tmp_path):
    """Another seed (the fingerprint), another live-field set, another
    format: each refused with its own message."""
    from zraytrace_tpu_torch.inverse import fit

    start, camera, target = _fit_setup()
    p = str(tmp_path / "fit.npz")
    kw = {**FIT_KW, "steps": 1}
    fit(start, camera, target, checkpoint_path=p, checkpoint_every=1, **kw)
    with pytest.raises(ValueError, match="different scene/target/config"):
        fit(start, camera, target, checkpoint_path=p, checkpoint_every=1,
            **{**kw, "steps": 2, "seed": 99})
    with pytest.raises(ValueError, match="live fields"):
        fit(start, camera, target, checkpoint_path=p, checkpoint_every=1,
            **{**kw, "optimize_fields": ("sph_radius", "sph_center")})
    with np.load(p) as z:
        old = {k: z[k] for k in z.files}
    np.savez(p, **{**old, "format": np.asarray(0)})
    with pytest.raises(ValueError, match="format 0"):
        fit(start, camera, target, checkpoint_path=p, checkpoint_every=1, **kw)


def _sharded_checkpoint_rank(rank, world, fields, cam, path):
    """On each of 4 ranks: the chunked render on a 2x2 mesh uninterrupted,
    cut after one chunk and resumed, the unchunked ``render_sharded``,
    and a resume on a 4x1 mesh (refused)."""
    import dataclasses

    from zraytrace_tpu_torch.checkpoint import render_sharded_checkpointed
    from zraytrace_tpu_torch.parallel.mesh import make_mesh, render_sharded

    scene, camera = _cross(fields, cam)
    mesh = make_mesh(2, 2, device="cpu")
    params = RenderParams(width=16, height=16, samples_per_pixel=8, max_depth=3)
    out = {}
    img, st = render_sharded_checkpointed(scene, camera, params, mesh, f"{path}/a.npz",
                                          chunk_spp=4)
    out["full"] = (img.numpy(), _counters(st))
    render_sharded_checkpointed(scene, camera, dataclasses.replace(params, samples_per_pixel=4),
                                mesh, f"{path}/b.npz", chunk_spp=4)
    img, st = render_sharded_checkpointed(scene, camera, params, mesh, f"{path}/b.npz",
                                          chunk_spp=4)
    out["resumed"] = (img.numpy(), _counters(st))
    img, st = render_sharded(scene, camera, params, mesh)
    out["unchunked"] = (img.numpy(), _counters(st))
    try:
        render_sharded_checkpointed(scene, camera, params, make_mesh(4, 1, device="cpu"),
                                    f"{path}/b.npz", chunk_spp=4)
        out["refused"] = ""
    except ValueError as e:
        out["refused"] = str(e)
    return out


def test_sharded_checkpointed_resume_bitexact(tmp_path, balls):
    from zraytrace_tpu_torch.parallel.multihost import run_ranks

    _, fields, cam = balls
    outs = run_ranks(_sharded_checkpoint_rank, 4, fields, cam, str(tmp_path), timeout=120)
    for out in outs:
        img_full, c_full = out["full"]
        img_res, c_res = out["resumed"]
        np.testing.assert_array_equal(img_full, img_res)
        np.testing.assert_array_equal(img_full, outs[0]["full"][0])
        assert c_full == c_res
        img_u, c_u = out["unchunked"]
        assert c_u == c_full
        np.testing.assert_allclose(img_u, img_full, rtol=2e-5, atol=2e-6)
        assert "different scene" in out["refused"]


def test_entry_points_need_a_card_by_default(tmp_path, mini):
    """``render_checkpointed`` runs on the card unless asked for the CPU."""
    _, fields, cam = mini
    scene, camera = _cross(fields, cam)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            render_checkpointed(scene, camera, RenderParams(width=4, height=4,
                                                            samples_per_pixel=1),
                                tmp_path / "x.npz")
    assert not (tmp_path / "x.npz").exists()
