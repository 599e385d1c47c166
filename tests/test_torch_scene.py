"""Scene building, conversion and image I/O of the PyTorch port against
the JAX package (and Pillow, for the PNG codec)."""

import numpy as np
import pytest
import torch
from PIL import Image

from zraytrace_tpu.io.png import quantize as jax_quantize
from zraytrace_tpu.scenes import three_balls as jax_three_balls
from zraytrace_tpu_torch import scenes
from zraytrace_tpu_torch.convert import camera_from_numpy, scene_from_numpy
from zraytrace_tpu_torch.io.png import decode_png, quantize, read_png, write_png
from zraytrace_tpu_torch.io.ppm import write_ppm
from zraytrace_tpu_torch.scene import Scene, SceneBuilder
from zraytrace_tpu_torch.textures import texture_albedo

torch.set_num_threads(1)

IMAGES = scenes.assets_dir() / "images"


@pytest.fixture(scope="module")
def both_scenes():
    return jax_three_balls(), scenes.three_balls("cpu")


def test_three_balls_equals_jax_field_by_field(both_scenes):
    """Exact: same 16 fields, shapes, dtypes and values (the atlas
    included, so the PNG reader is exact too)."""
    jb, tb = both_scenes
    assert tb.name == jb.name
    assert Scene._fields == type(jb.scene)._fields
    for name, jv in jb.scene._asdict().items():
        want = np.asarray(jv)
        got = getattr(tb.scene, name).numpy()
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert tb.scene.atlas.shape == (2, 512, 1024, 3)


def test_three_balls_camera_matches_jax(both_scenes):
    """f32 camera frame; tan/normalize may round differently by an ulp."""
    jb, tb = both_scenes
    for jv, tv in zip(jb.camera, tb.camera):
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6, atol=1e-7)


def test_scene_from_numpy_round_trip(both_scenes):
    jb, tb = both_scenes
    fields = {k: np.asarray(v) for k, v in jb.scene._asdict().items()}
    scene = scene_from_numpy(fields, "cpu")
    for name in Scene._fields:
        assert torch.equal(getattr(scene, name), getattr(tb.scene, name)), name
    # and back out through numpy again
    again = scene_from_numpy({k: v.numpy() for k, v in scene._asdict().items()}, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(again, scene))
    cam = camera_from_numpy(*map(np.asarray, jb.camera), device="cpu")
    for jv, tv in zip(jb.camera, cam):
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    with pytest.raises(ValueError):
        scene_from_numpy({k: v for k, v in fields.items() if k != "atlas"}, "cpu")


@pytest.mark.parametrize("name", ["earthmap.png", "nitor-logo-25.png"])
def test_png_decoder_equals_pillow(name):
    """Exact bytes: colour type 2 (earthmap) and 6 (nitor logo), every
    scanline filter type the files use."""
    path = IMAGES / name
    got = decode_png(path.read_bytes())
    with Image.open(path) as im:
        want = np.asarray(im)
    assert got.shape == want.shape and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def test_png_decoder_all_filter_types():
    """A PNG written by Pillow with adaptive filtering decodes exactly."""
    import io

    r = np.random.default_rng(5)
    smooth = np.cumsum(r.integers(0, 3, (37, 53, 4)), axis=1).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(smooth, "RGBA").save(buf, format="PNG", optimize=True)
    np.testing.assert_array_equal(decode_png(buf.getvalue()), smooth)


def test_png_writer_reads_back_through_pillow(tmp_path):
    r = np.random.default_rng(3)
    img = r.random((16, 24, 3)).astype(np.float32) * 1.2 - 0.1
    path = tmp_path / "t.png"
    write_png(path, img)
    with Image.open(path) as im:
        assert im.mode == "RGB"
        back = np.asarray(im)
    # file row 0 is the image top: the writer flips
    np.testing.assert_array_equal(back, jax_quantize(img)[::-1])
    np.testing.assert_array_equal(quantize(img), jax_quantize(img))
    # and the port's reader undoes the flip
    np.testing.assert_array_equal(read_png(path), quantize(img).astype(np.float32) / 255.0)


def test_ppm_reference_byte_size_anchor(tmp_path):
    """ppm_image.zig:70-83: a 10x10 black image with the reference's
    filename string is exactly 1,446 bytes."""
    path = tmp_path / "img-file.ppm"
    write_ppm(path, np.zeros((10, 10, 3), np.float32),
              header_filename="./target/img-file.ppm")
    assert path.stat().st_size == 1446


def test_earthmap_golden_values():
    """texture.zig:96-103 with zero offsets, as tests/test_textures.py."""
    b = SceneBuilder()
    t = b.add_image_texture(read_png(IMAGES / "earthmap.png"), u_offset=0.0, v_offset=0.0)
    b.add_lambertian(t)
    b.add_sphere((0, 0, 0), 1.0, 0)
    scene = b.build("cpu")
    uv = torch.tensor([[0.0, 0.0], [0.1, 0.1], [0.5, 0.5], [1.0, 1.0]])
    out = texture_albedo(scene, torch.full((4,), t, dtype=torch.int32), uv)
    expected = np.array([
        [9.21568632e-01, 9.37254905e-01, 9.49019610e-01],
        [9.25490200e-01, 9.45098042e-01, 9.56862747e-01],
        [0.0, 7.84313771e-03, 2.07843139e-01],
        [1.0, 1.0, 1.0],
    ])
    np.testing.assert_allclose(out.numpy(), expected, atol=1e-6)


def test_texture_wrap_and_offsets_match_jax():
    """Nearest lookups at seeded uvs, including wraps on both axes, equal
    the JAX lookup exactly."""
    import jax.numpy as jnp

    from zraytrace_tpu.scene import SceneBuilder as JaxBuilder
    from zraytrace_tpu.textures import texture_albedo as jax_albedo

    r = np.random.default_rng(11)
    img = r.random((7, 9, 3)).astype(np.float32)
    jb, tb = JaxBuilder(), SceneBuilder()
    for b in (jb, tb):
        b.add_color_texture((0.1, 0.2, 0.3))
        b.add_image_texture(img, u_offset=0.4, v_offset=0.7)
        b.add_lambertian(1)
        b.add_sphere((0, 0, 0), 1.0, 0)
    uv = r.random((500, 2)).astype(np.float32)
    ids = r.integers(0, 2, 500).astype(np.int32)
    want = np.asarray(jax_albedo(jb.build(), jnp.asarray(ids), jnp.asarray(uv)))
    got = texture_albedo(tb.build("cpu"), torch.from_numpy(ids), torch.from_numpy(uv))
    np.testing.assert_array_equal(got.numpy(), want)


def test_mesh_scenes_name_their_roadmap_item():
    """The mesh scenes of ROADMAP.md Queue 1 item 8 build now (their
    fields are held to JAX's in tests/test_torch_mesh.py); scene 5's asset
    is absent upstream, as in the JAX package."""
    for index, name in ((0, "manAndBall"), (2, "bunnyAndBall"), (3, "teapotAndBall"),
                        (4, "teapotAndBallCircle")):
        built = scenes.build_scene(index, "cpu")
        assert built.name == name and built.scene.n_triangles > 0
    with pytest.raises(FileNotFoundError):
        scenes.build_scene(5, "cpu")
    with pytest.raises(KeyError):
        scenes.build_scene(9, "cpu")
