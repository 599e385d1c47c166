"""The port's render path against the JAX package, on the CPU.

The plain PyTorch wavefront defines the port's event counters and is the
reference the CUDA bounce kernel is held to on the card, so it is held
here to the JAX engines at the sizes of tests/test_pallas3.py: counters
exactly equal, images within that file's texel-flip bar (XLA's and
torch's acos/atan2 may pick a neighbouring texel on rare lanes).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zraytrace_tpu.config import RenderParams as JaxParams
from zraytrace_tpu.ops.bounce_kernel3 import wavefront_trace_pallas3
from zraytrace_tpu.render import render as jax_render
from zraytrace_tpu.render import wavefront_trace as jax_wavefront
from zraytrace_tpu.scenes import three_balls as jax_three_balls
from zraytrace_tpu_torch import RenderParams
from zraytrace_tpu_torch.convert import camera_from_numpy, scene_from_numpy
from zraytrace_tpu_torch.ops import bounce_kernel as bk
from zraytrace_tpu_torch.profiling import counter
from zraytrace_tpu_torch.render import render, wavefront_trace

torch.set_num_threads(1)


def _assert_images_close(sx, sp):
    """tests/test_pallas3.py's bar: rare texel-boundary lanes may differ."""
    diff = np.abs(sx - sp)
    assert (diff > 1e-4).mean() < 0.05, diff.max()
    assert np.median(diff) < 1e-5


def _jax_counters(c) -> list:
    return [int(hi) * (1 << 32) + int(lo) for hi, lo in np.asarray(c)]


@pytest.fixture(scope="module")
def built():
    """The same scene in both packages, crossed over through numpy."""
    jb = jax_three_balls()
    scene = scene_from_numpy({k: np.asarray(v) for k, v in jb.scene._asdict().items()}, "cpu")
    camera = camera_from_numpy(*map(np.asarray, jb.camera), device="cpu")
    return jb, scene, camera


@pytest.fixture(scope="module")
def plain_16(built):
    """The plain wavefront at 16x16, spp 2, depth 6, 256 lanes."""
    _, scene, camera = built
    base = torch.arange(256, dtype=torch.int32)
    sums, counters = wavefront_trace(scene, camera, base, 42, 16, 16, 2, 6, 0, 256, 256, 1)
    return sums.numpy(), counters.tolist()


def test_plain_wavefront_matches_jax_wavefront(built, plain_16):
    jb, _, _ = built
    base = jnp.arange(256, dtype=jnp.int32)
    sx, cx = jax_wavefront(jb.scene, jb.camera, base, 42, 16, 16, 2, 6, 0, None, 256, 256, 1)
    sums, counters = plain_16
    assert sums.shape == (1, 256, 3) and sums.dtype == np.float32
    # all six: the iteration count is the lockstep step count in both
    assert counters == _jax_counters(cx)
    _assert_images_close(np.asarray(sx), sums)


def test_plain_wavefront_matches_pallas3_interpret(built, plain_16):
    """The TPU kernel this port replaces, run in interpret mode as
    tests/test_pallas3.py runs it."""
    jb, _, _ = built
    base = jnp.arange(256, dtype=jnp.int32)
    sp, cp = wavefront_trace_pallas3(jb.scene, jb.camera, base, 42, 16, 16, 2, 6,
                                     0, 1, 256, 256, n_bounce=6)
    sums, counters = plain_16
    assert counters[:5] == _jax_counters(cp)[:5]
    _assert_images_close(np.asarray(sp), sums)


def test_counter_identities(plain_16):
    rays, refl, bg, rec, samples, iters = plain_16[1]
    assert samples == 16 * 16 * 2
    assert rays == refl + samples - rec  # each ray scatters or ends a sample
    assert bg + rec <= samples and iters > 0


def test_multi_slot_and_sample_offset_match_jax(built):
    """Two strided pixels per lane, a ragged last slot (200 pixels over
    128 lanes) and samples [3, 5): counters exact, images close."""
    jb, scene, camera = built
    args = (42, 20, 10, 2, 5, 3, 128, 200, 2)
    sx, cx = jax_wavefront(jb.scene, jb.camera, jnp.arange(128, dtype=jnp.int32),
                           *args[:6], None, *args[6:])
    st, ct = wavefront_trace(scene, camera, torch.arange(128, dtype=torch.int32), *args)
    assert ct.tolist() == _jax_counters(cx)
    assert ct[4] == 200 * 2
    _assert_images_close(np.asarray(sx), st.numpy())


def test_render_matches_jax_render(built):
    """render() at 32x24, spp 2, depth 4 against JAX render() on its XLA
    wavefront."""
    jb, scene, camera = built
    jimg, jst = jax_render(jb.scene, jb.camera,
                           JaxParams(width=32, height=24, samples_per_pixel=2,
                                     max_depth=4, use_pallas=False))
    img, st = render(scene, camera, RenderParams(width=32, height=24,
                                                 samples_per_pixel=2, max_depth=4), "cpu")
    assert img.shape == (24, 32, 3) and img.dtype == torch.float32
    for k in ("rays", "reflections", "background_hits", "recursion_depth_hits",
              "samples", "pixels", "wavefront_iterations"):
        assert getattr(st, k) == getattr(jst, k), k
    assert st.samples == 32 * 24 * 2
    assert st.rays == st.reflections + st.samples - st.recursion_depth_hits
    _assert_images_close(np.asarray(jimg), img.numpy())


def test_render_slot_layout_invariant(built):
    """A narrow wavefront (several pixels per lane) traces the same
    streams: identical counters and images to the one-slot layout."""
    _, scene, camera = built
    wide = render(scene, camera, RenderParams(20, 12, 2, 4), "cpu")
    narrow = render(scene, camera, RenderParams(20, 12, 2, 4, max_wavefront=64), "cpu")
    for k in ("rays", "reflections", "background_hits", "recursion_depth_hits", "samples"):
        assert getattr(wide[1], k) == getattr(narrow[1], k), k
    assert torch.equal(wide[0], narrow[0])


def test_bounce_trace_on_cpu_runs_the_plain_version(built, plain_16):
    """On a CPU tensor the kernel's wrapper runs the plain wavefront and
    launches nothing."""
    _, scene, camera = built
    before = counter("launch.bounce")
    sums, counters = bk.bounce_trace(scene, camera, torch.arange(256, dtype=torch.int32),
                                     42, 16, 16, 2, 6, 0, 256, 256, 1)
    assert counter("launch.bounce") == before
    assert counters.tolist() == plain_16[1]
    np.testing.assert_array_equal(sums.numpy(), plain_16[0])
    assert bk.wavefront_trace_reference is wavefront_trace


def test_scene_tables_layout(built):
    """The kernel's tables follow zraytrace_tpu/ops/common.py's layout."""
    from zraytrace_tpu.ops.common import prepare_tables

    jb, scene, camera = built
    want = prepare_tables(jb.scene, jb.camera)
    spheres, mats, cam = bk.scene_tables(scene, camera)
    np.testing.assert_array_equal(spheres.numpy(), np.asarray(want.spheres))
    np.testing.assert_array_equal(mats.numpy(), np.asarray(want.mats))
    np.testing.assert_array_equal(cam.numpy(), np.asarray(want.cam))


def test_cuda_device_without_a_card_raises(built):
    """The device is the caller's choice: no silent CPU fallback."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; tests/test_torch_gpu.py covers it")
    _, scene, camera = built
    with pytest.raises(RuntimeError, match="CUDA"):
        render(scene, camera, RenderParams(8, 8, 1, 2), device="cuda")


def test_default_device_is_the_card(built):
    """Entry points run on the card unless the caller asks for the CPU:
    without one, calling them with no device raises instead of rendering
    on the host."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; tests/test_torch_gpu.py covers it")
    from zraytrace_tpu_torch.camera import make_camera
    from zraytrace_tpu_torch.scene import SceneBuilder
    from zraytrace_tpu_torch.scenes import build_scene

    _, scene, camera = built
    with pytest.raises(RuntimeError, match="CUDA"):
        render(scene, camera, RenderParams(8, 8, 1, 2))
    b = SceneBuilder()
    b.add_sphere((0, 0, 0), 1.0, b.add_lambertian_color((0.5, 0.5, 0.5)))
    for call in (lambda: build_scene(1), b.build,
                 lambda: make_camera((0, 0, -1), (0, 0, 0), (0, 1, 0), 45.0, 1.0),
                 lambda: camera_from_numpy(*map(np.asarray, camera))):
        with pytest.raises((RuntimeError, AssertionError)):
            call()


def test_cli_cpu_writes_png(tmp_path):
    from PIL import Image

    from zraytrace_tpu_torch.cli import main

    out = tmp_path / "out.png"
    assert main(["12", "8", "1", "3", "1", str(out), "--cpu", "--ppm"]) == 0
    with Image.open(out) as im:
        assert im.size == (12, 8) and im.mode == "RGB"
    assert (tmp_path / "out.png.ppm").exists()
    mesh = tmp_path / "mesh.png"
    assert main(["8", "6", "1", "2", "3", str(mesh), "--cpu"]) == 0
    with Image.open(mesh) as im:
        assert im.size == (8, 6)
    with pytest.raises(FileNotFoundError):  # scene 5's asset is absent upstream
        main(["8", "8", "1", "2", "5", str(tmp_path / "goat.png"), "--cpu"])
