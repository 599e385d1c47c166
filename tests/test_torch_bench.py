"""The port's bench (``zraytrace_tpu_torch/bench.py``,
``zraytrace_tpu_torch/tools/diff_bench.py``) and the last small modules
(``geometry/aabb.py``, ``bvh_depth_stats``, ``random_in_unit_sphere``)
against the JAX package, on the CPU at cut sizes.

- The render cells' pass function, on samples ``[1, 1 + spp)``: counters
  equal to JAX's ``_wavefront_jit`` (the engine ``bench.py`` times) at
  ``sample_start=1`` exactly, on the brute route, and sums within
  tests/test_torch_render.py's image bar.
- The pass is ``render()``'s own code: on ``render.lanes`` (one slot or
  several) its counters and decoded image equal ``render()``'s.
- The JSON line's fields and the bench's own checks, its failures, and
  its refusal to run on the host without ``--cpu``.
- The fit cells: ``rays_forward`` equal to JAX's ``render()`` at the same
  configuration, and the first step's loss and gradients against the JAX
  package's loss built as ``tools/diff_bench.py`` builds it (loss within
  rtol 1e-5, gradients within ``atol = 5e-4 max|g|``, ``rtol = 2e-3``).
"""

import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_diff import GRAD_ATOL, GRAD_RTOL, _assert_grads
from zraytrace_tpu import scene as jsc
from zraytrace_tpu.camera import make_camera as jax_make_camera
from zraytrace_tpu.config import RenderParams as JaxParams
from zraytrace_tpu.geometry import aabb as jaabb
from zraytrace_tpu.geometry.bvh import build_tri_bvh as jax_build_tri_bvh
from zraytrace_tpu.geometry.bvh import bvh_depth_stats as jax_bvh_depth_stats
from zraytrace_tpu.inverse import image_loss as jax_image_loss
from zraytrace_tpu.inverse import merge_scene as jmerge
from zraytrace_tpu.inverse import split_scene as jsplit
from zraytrace_tpu.ops.flash_intersect import pack_tri_planes as jax_pack_tri_planes
from zraytrace_tpu.render import _wavefront_jit
from zraytrace_tpu.render import render as jax_render
from zraytrace_tpu.render_diff import render_diff as jax_render_diff
from zraytrace_tpu.rng import random_in_unit_sphere as jax_random_in_unit_sphere
from zraytrace_tpu.scenes import build_scene as jax_build_scene
from zraytrace_tpu_torch import bench, render, showcase
from zraytrace_tpu_torch import rng as trng
from zraytrace_tpu_torch.geometry import aabb
from zraytrace_tpu_torch.geometry.bvh import build_tri_bvh, bvh_depth_stats
from zraytrace_tpu_torch.kernel_inputs import POSE_EPS, POSE_START, pose_adam_step, pose_image
from zraytrace_tpu_torch.scenes import teapot_on_ground
from zraytrace_tpu_torch.tools import diff_bench

from torch_jax_native import jax_native  # noqa: F401  (an autouse fixture)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
SEED = 42


def _jax_counters(c) -> list:
    return [int(hi) * (1 << 32) + int(lo) for hi, lo in np.asarray(c)]


def _assert_images_close(a, b):
    """tests/test_torch_render.py's bar: rare texel-boundary lanes may differ."""
    diff = np.abs(a - b)
    assert (diff > 1e-4).mean() < 0.05, diff.max()
    assert np.median(diff) < 1e-5


def _root_bench():
    """The JAX package's ``bench.py`` (it imports only the standard library
    at module level)."""
    spec = importlib.util.spec_from_file_location("_root_bench", ROOT / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# -- the render cells' engine against JAX's ------------------------------------


@pytest.mark.parametrize("index, spp, depth", [(1, 2, 4), (3, 1, 3)], ids=["scene1", "scene3"])
def test_pass_matches_jax_wavefront(index, spp, depth):
    """The bench's pass of samples [1, 1 + spp) at 16x12 equals JAX's
    engine at ``sample_start=1`` (brute route: ``tri_bvh=None``,
    ``tri_flash=None``): all six counters exactly, sums within the bar."""
    w, h = 16, 12
    e = bench.render_engine(index, w, h, CPU)
    assert e.route.kernel and e.route.tri_flash is None  # render()'s CPU route
    assert (e.lay.n_lanes, e.lay.n_slots) == (w * h, 1)
    got = bench.run_pass(e, SEED, spp, depth, 1)
    assert got.device_ms is None and got.launches == (0, 0)
    jb = jax_build_scene(index)
    sx, cx = _wavefront_jit(jb.scene, jb.camera, jnp.arange(e.lay.n_lanes, dtype=jnp.int32),
                            SEED, w, h, spp, depth, 1, None, e.lay.n_lanes, w * h, e.lay.n_slots,
                            None, False, 1)
    assert got.counters == _jax_counters(cx)
    assert got.counters[4] == w * h * spp
    _assert_images_close(np.asarray(sx), got.sums.numpy())
    # sample 0 is another stream: the warm-up does not count toward the pass
    assert bench.run_pass(e, SEED, spp, depth, 0).counters != got.counters


@pytest.mark.parametrize("max_wavefront", [1 << 20, 20], ids=["one_slot", "three_slots"])
def test_pass_is_renders_code(max_wavefront):
    """A pass of samples [0, spp) on ``render.lanes`` is ``render()``:
    the same counters and, through ``render.fetch_sums`` and
    ``render.decode``, the same image."""
    from zraytrace_tpu_torch.config import RenderParams

    w, h, spp, depth = 8, 6, 2, 3
    e = bench.render_engine(3, w, h, CPU)
    lay = render.lanes(w, h, max_wavefront, CPU)
    assert (lay.n_lanes, lay.n_slots) == (min(w * h, max_wavefront), -(-w * h // lay.n_lanes))
    e = e._replace(lay=lay)
    got = bench.run_pass(e, SEED, spp, depth, 0)
    image, stats = render.render(e.scene, e.camera, RenderParams(
        width=w, height=h, samples_per_pixel=spp, max_depth=depth, seed=SEED,
        max_wavefront=max_wavefront), CPU)
    assert got.counters[:5] == [stats.rays, stats.reflections, stats.background_hits,
                                stats.recursion_depth_hits, stats.samples]
    assert torch.equal(render.decode(render.fetch_sums(got.sums, lay), lay, spp), image)


# -- the JSON line ---------------------------------------------------------------


def _passes(seconds, rays=1000):
    return [bench.Pass([rays, 0, 0, 0, 10, 1], s, None, (0, 0), None) for s in seconds]


def test_zig_rates_are_bench_py_constants():
    ref = _root_bench()
    assert bench.REF_RAYS_PER_SEC == ref.REF_RAYS_PER_SEC
    assert bench.REF_TEAPOT_RAYS_PER_SEC == ref.REF_TEAPOT_RAYS_PER_SEC
    assert bench.RENDER_CELLS[1].baseline == ref.REF_RAYS_PER_SEC
    assert bench.RENDER_CELLS[3].baseline == ref.REF_TEAPOT_RAYS_PER_SEC


@pytest.mark.parametrize("seconds, mid", [([0.5, 0.2, 0.3], 0.3), ([0.3, 0.1, 0.2, 0.4], 0.3),
                                          ([0.25], 0.25)], ids=["odd", "even", "one"])
def test_render_line_fields(seconds, mid):
    """``value`` and ``elapsed`` are the median pass's (the slower middle
    one with an even count), ``spread_pct`` follows bench.py:237-239."""
    info = dict(device="cpu", power_limit=None)
    line = bench.render_line("m_cpu", 2.0, _passes(seconds), info)
    assert line["elapsed"] == mid and line["value"] == 1000 / mid
    assert line["window_rate"] == pytest.approx(1000 * len(seconds) / sum(seconds), rel=1e-12)
    assert line["vs_baseline"] == line["value"] / 2.0
    rates = [1000 / s for s in seconds]
    want = 100.0 * (max(rates) - min(rates)) / line["value"] if len(seconds) > 1 else 0.0
    assert line["spread_pct"] == pytest.approx(want, rel=1e-12)
    assert line["passes"] == len(seconds) and line["pass_seconds"] == seconds
    assert line["rays"] == 1000 and line["samples"] == 10 and line["unit"] == "rays/s/chip"


def test_cpu_lines(capsys):
    """``--all --cpu`` at a cut size prints four correct lines under the
    ``_cpu`` names, ``elapsed`` the median of the pass times."""
    assert bench.main(["--all", "--cpu", "--size", "8", "--spp", "1", "--depth", "2",
                       "--steps", "1", "--repeats", "3"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x["metric"] for x in lines] == [
        "rays_per_second_7spheres_1000x1000_cpu", "rays_per_second_teapot_700x700_cpu",
        "diff_step_eff_rays_per_s_sphere_albedo_fit_cpu",
        "diff_step_eff_rays_per_s_teapot_pose_fit_cpu"]
    for x in lines:
        assert x["correct"] and "error" not in x and x["device"] == "cpu", x
        assert x["value"] > 0
    for x in lines[:2]:
        assert x["elapsed"] == sorted(x["pass_seconds"])[1] and x["passes"] == 3
        assert x["value"] == x["rays"] / x["elapsed"] and x["samples"] == 64
        assert x["checks"] == {"identities": True, "passes_equal": True}  # no record at 8x8
    for x in lines[2:]:
        assert x["steps"] == 1 and x["launches_per_step"] == [0, 0, 0]
        assert x["window_rate"] == pytest.approx(x["rays_forward"] / x["step_seconds"],
                                                 rel=1e-12)
        assert x["checks"] == {"finite": True, "rays_forward_identities": True}


@pytest.mark.parametrize("off, ok", [(5e-5, True), (2e-4, False)], ids=["5e-5", "2e-4"])
def test_showcase_check(off, ok):
    """Scene 1's counters against showcase/SWEEP.md's 1000x1000x1000 d30
    row: accepted 5e-5 off per sample, refused 2e-4 off."""
    cell = bench.RENDER_CELLS[1]._replace(png=False)
    rec = showcase.record("threeBalls", 1000, 1000, 1000, 30)
    assert rec.samples == 10 ** 9
    counters = list(rec.counts) + [rec.samples, 1]
    counters[1] += int(off * rec.samples)  # reflections, and so the rays
    counters[0] += int(off * rec.samples)
    first = bench.Pass(counters, 1.0, None, (0, 0), None)
    lay = render.Lanes(1000, 1000, 1 << 20, 1, torch.zeros(1))
    e = bench.Engine("threeBalls", None, None, None, lay)
    checks = bench.render_checks(e, cell, 1000, 30, first, [first])
    assert checks["identities"] and checks["passes_equal"]
    assert checks["events_per_sample_off"] == pytest.approx(off)
    assert checks["events"] is ok


def test_showcase_reader():
    """The reader's rows and images: the scene-3 record the bench holds
    the teapot to, and scene 1's PNG."""
    rec = showcase.record("teapotAndBall", 700, 700, 100, 20)
    assert rec.counts == (82484798, 33484817, 48999981, 19) and rec.samples == 49_000_000
    png = showcase.png("threeBalls", 1000, 1000, 1000)
    assert png.shape[:2] == (1000, 1000) and png.dtype == np.uint8
    assert showcase.mean_8bit_diff(png[::-1, :, :3] / 255.0, png) < 0.01
    with pytest.raises(LookupError):
        showcase.record("threeBalls", 1000, 1000, 7, 30)


# -- failures ----------------------------------------------------------------------


def test_failing_cell_prints_its_line_and_fails(capsys, monkeypatch):
    from zraytrace_tpu_torch import render

    def broken(*args, **kwargs):
        raise RuntimeError("engine down")

    monkeypatch.setattr(render, "trace_route", broken)
    assert bench.main(["--cpu", "--scene", "3", "--size", "8", "--spp", "1",
                       "--depth", "2"]) == 1
    line = json.loads(capsys.readouterr().out.strip())
    assert line["metric"] == "rays_per_second_teapot_700x700_cpu"
    assert line["value"] is None and line["correct"] is False
    assert line["error"] == "RuntimeError: engine down"


def test_failed_check_is_an_error(monkeypatch):
    """A cell whose check fails keeps its measured value and gets an error."""
    def bad_checks(*args, **kwargs):
        return dict(identities=True, passes_equal=False)

    monkeypatch.setattr(bench, "render_checks", bad_checks)
    line = bench.run_cell("scene1", CPU, repeats=1, size=8, spp=1, depth=2)
    assert line["value"] > 0 and line["correct"] is False
    assert "passes_equal" in line["error"]


def test_no_card_no_cpu_fails(capsys, monkeypatch):
    """Without a card and without ``--cpu`` the bench fails before any
    render."""
    from zraytrace_tpu_torch import render

    def never(*args, **kwargs):
        raise AssertionError("rendered without a card")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(render, "trace_route", never)
    assert bench.main(["--scene", "1"]) == 2
    out = capsys.readouterr()
    assert out.out == "" and "--cpu" in out.err


# -- the fit cells ------------------------------------------------------------------


def test_sphere_albedo_fit_matches_jax():
    """16x16, 2 spp, depth 3: ``rays_forward`` equals JAX's ``render()``;
    the first step's loss and gradients equal JAX's
    (tools/diff_bench.py:80-97)."""
    size, spp, depth = 16, 2, 3
    entry = diff_bench.bench_sphere_albedo(size, spp, depth, steps=1, device=CPU)
    jb = jax_build_scene(1)
    _, jst = jax_render(jb.scene, jb.camera, JaxParams(width=size, height=size,
                                                       samples_per_pixel=spp, max_depth=depth,
                                                       seed=SEED))
    assert entry["rays_forward"] == jst.rays
    assert entry["correct"] and entry["checks"]["all_leaves"]["finite"]
    assert entry["step_seconds_all_leaves"] > 0 and entry["step_seconds"] > 0

    params, static = jsplit(jb.scene)
    fields = diff_bench.FIT_FIELDS
    live = {f: params[f] for f in fields}
    rest = {**static, **{f: v for f, v in params.items() if f not in fields}}
    target = jnp.zeros((size, size, 3), jnp.float32)

    def jloss(p):
        img = jax_render_diff(jmerge(p, rest), jb.camera, size, size, spp, depth, seed=SEED,
                              edge_eps=diff_bench.SPHERE_EDGE)
        return jax_image_loss(img, target)

    want, jgrads = jax.value_and_grad(jloss)(live)
    step, leaves, _, _ = diff_bench.sphere_albedo_step(CPU, size, spp, depth)
    loss = step()
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-5)
    assert float(loss) == entry["loss_first"]
    _assert_grads({f: leaves[f].grad for f in fields}, jgrads, fields)


def test_teapot_pose_fit_matches_jax():
    """16x16, 1 spp, depth 2: ``rays_forward`` equals JAX's ``render()`` at
    the start offset; the first step's loss equals JAX's
    (tools/diff_bench.py:146-190) and its target image JAX's within
    tests/test_torch_diff.py's image bar.

    The pose gradient is held to JAX's pixel by pixel: its y component is
    a sum of pixel terms of up to 0.024 that cancel to 1.7e-5, below the
    bar's ``atol``, so the bar (``atol = 5e-4`` of the largest term,
    ``rtol = 2e-3``) is applied to each pixel's term, JAX's from one
    vmapped VJP of the image, the port's from one batched backward of
    ``pose_image``; the step's gradient is their sum. The terms are each
    package's own, on JAX's eager engine: jitted, JAX's own gradient moves
    by 7.8e-4 in y (ROADMAP Queue 3 (b))."""
    size, spp, depth = 16, 1, 2
    entry = diff_bench.bench_teapot_pose(size, spp, depth, steps=1, device=CPU)
    assert entry["correct"] and entry["config"]["triangles"] == 6320

    jb = jax_build_scene(3)  # for its teapot triangles
    a, bb, c = (np.asarray(x) for x in (jb.scene.tri_a, jb.scene.tri_b, jb.scene.tri_c))
    b = jsc.SceneBuilder()
    b.add_sphere((0.0, -102.33, 7.0), 100.0, b.add_lambertian_color(jsc.COLOR_GREEN))
    b.add_triangles(a, bb, c, b.add_lambertian_color((0.7, 0.15, 0.1)))
    base = b.build()
    camera = jax_make_camera((0.0, 3.0, -9.0), (0.0, 1.0, 5.0), (0.0, 1.0, 0.0), 50.0, 1.0)
    order = jax_build_tri_bvh(base.tri_a, base.tri_b, base.tri_c).prim_order
    off0 = np.asarray(POSE_START, np.float32)
    scene0 = base._replace(tri_a=base.tri_a + off0, tri_b=base.tri_b + off0,
                           tri_c=base.tri_c + off0)
    _, jst = jax_render(scene0, camera, JaxParams(width=size, height=size,
                                                  samples_per_pixel=spp, max_depth=depth,
                                                  seed=SEED))
    assert entry["rays_forward"] == jst.rays

    def image_at(off):
        s = base._replace(tri_a=base.tri_a + off, tri_b=base.tri_b + off,
                          tri_c=base.tri_c + off)
        tf = jax_pack_tri_planes(s.tri_a, s.tri_b, s.tri_c, order=order)
        return jax_render_diff(s, camera, size, size, spp, depth, seed=SEED, mesh_fast=True,
                               tri_flash=tf, edge_eps=(0.015, 0.03), edge_occlusion=False)

    target = np.asarray(image_at(jnp.zeros((3,), jnp.float32)))
    jimg, vjp = jax.vjp(image_at, jnp.asarray(off0))
    want = float(jnp.mean((jimg - target) ** 2))
    np.testing.assert_allclose(entry["loss_first"], want, rtol=1e-5)

    tb = teapot_on_ground(CPU)
    tord = build_tri_bvh(tb.scene.tri_a, tb.scene.tri_b, tb.scene.tri_c).prim_order
    dims = dict(width=size, height=size, spp=spp, depth=depth)
    with torch.no_grad():
        own = pose_image(tb.scene, tb.camera, tord, torch.zeros(3), POSE_EPS, **dims)
    np.testing.assert_allclose(own.numpy(), target, rtol=0, atol=2e-5)

    n = size * size
    pick = np.zeros((n, size, size, 3), np.float32)  # one pixel a row
    pick[np.arange(n), np.arange(n) // size, np.arange(n) % size] = 1.0
    jterms = np.asarray(jax.vmap(lambda c: vjp(c)[0])(
        jnp.asarray(pick * (2.0 * (np.asarray(jimg) - target) / jimg.size))))
    step, off = pose_adam_step(tb.scene, tb.camera, tord, own, **dims)
    x = off.detach().clone().requires_grad_(True)
    img = pose_image(tb.scene, tb.camera, tord, x, POSE_EPS, **dims)
    cot = torch.from_numpy(pick) * (2.0 * (img.detach() - own) / img.numel())
    tterms = torch.autograd.grad(img, x, grad_outputs=cot, is_grads_batched=True)[0].numpy()
    assert np.abs(jterms).max() > 0 and (np.abs(jterms).max(axis=1) > 0).sum() > 10
    scale = np.abs(jterms).max()
    np.testing.assert_allclose(tterms, jterms, atol=GRAD_ATOL * scale, rtol=GRAD_RTOL)
    loss = step()
    np.testing.assert_allclose(float(loss), want, rtol=1e-5)
    np.testing.assert_allclose(off.grad.numpy(), tterms.sum(0), rtol=1e-4, atol=1e-9)


def test_grad_bar_is_the_ports():
    assert (GRAD_ATOL, GRAD_RTOL) == (5e-4, 2e-3)


def test_diff_bench_report_and_refusal(tmp_path):
    """The report ``main`` writes, at a cut size, has ``DIFF_BENCH.json``'s
    fields and the port's; its last line names the ``_cpu`` metric; ``main``
    refuses to write the JAX package's record."""
    cut = dict(size=8, spp=1, depth=2)
    rep = json.loads(json.dumps(diff_bench.compute_report(CPU, 1, sphere=cut, teapot=cut)))
    ref = json.loads((ROOT / "DIFF_BENCH.json").read_text())
    assert set(ref) <= set(rep) and set(rep["workloads"]) == set(ref["workloads"])
    for name, w in rep["workloads"].items():
        assert set(ref["workloads"][name]) - {"compile_seconds"} <= set(w), name
        assert w["correct"] and w["first_step_seconds"] > 0
        assert w["eff_rays_per_s_window"] == pytest.approx(
            w["rays_forward"] * w["steps"] / sum(w["step_seconds_list"]), rel=1e-12)
    assert rep["device"] == "cpu" and rep["torch_version"] == torch.__version__
    assert "cpu_model" in rep and rep["wall_seconds"] > 0
    last = diff_bench.last_line(rep)
    assert last["metric"] == "diff_step_eff_rays_per_s_cpu" and last["device"] == "cpu"
    assert last["value"] == rep["workloads"]["sphere_albedo_fit"]["eff_rays_per_s"]
    assert last["teapot_pose_fit"] == rep["workloads"]["teapot_pose_fit"]["eff_rays_per_s"]
    with pytest.raises(SystemExit):
        diff_bench.main(["--cpu", "--out", str(tmp_path / "DIFF_BENCH.json")])


def test_diff_bench_torch_artifact():
    """If the port's committed report exists it carries both workloads,
    exact ray counts, and the card it ran on."""
    path = ROOT / "DIFF_BENCH_TORCH.json"
    if not path.exists():
        pytest.skip("DIFF_BENCH_TORCH.json not generated yet")
    rep = json.loads(path.read_text())
    for name in ("sphere_albedo_fit", "teapot_pose_fit"):
        w = rep["workloads"][name]
        assert w["rays_forward"] > 0 and w["eff_rays_per_s"] > 0 and w["step_seconds"] > 0
        assert w["correct"] and w["steps"] >= 10
    assert rep["device"].startswith("NVIDIA") and rep["power_limit"]


# -- the small gaps -----------------------------------------------------------------


def _boxes(mn, mx):
    return jaabb.from_min_max(jnp.asarray(mn), jnp.asarray(mx)), aabb.from_min_max(mn, mx)


AABB_CASES = {
    "from_vertices": lambda m: m.from_vertices(
        [[1.0, 2.0, 3.0], [-1.0, 5.0, 0.0], [0.0, 0.0, 10.0]]),
    "merge": lambda m: m.merge(m.from_min_max([0, 0, 0], [1, 1, 1]),
                               m.from_min_max([-1, 0.5, 0], [0.5, 2, 3])),
    "merge_all": lambda m: m.merge_all(
        (jnp if m is jaabb else torch).stack([m.from_min_max([0, 0, 0], [1, 1, 1]),
                                              m.from_min_max([2, -1, 0], [3, 0, 5])])),
    "volume": lambda m: m.volume(m.from_min_max([0, 0, 0], [2, 3, 4])),
    "surface_area_reference": lambda m: m.surface_area_reference(
        m.from_min_max([0, 0, 0], [1, 2, 3])),
    "surface_area": lambda m: m.surface_area(m.from_min_max([0, 0, 0], [1, 2, 3])),
}


@pytest.mark.parametrize("case", sorted(AABB_CASES))
def test_aabb_matches_jax(case):
    """tests/test_aabb.py's cases, the port's values equal to the JAX
    module's."""
    want = np.asarray(AABB_CASES[case](jaabb))
    got = AABB_CASES[case](aabb)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_aabb_slab_hit_matches_jax():
    """The slab cases of tests/test_aabb.py (through, away, sideways, an
    axis-parallel ray, a batch of boxes) and 1,000 random ray-box pairs."""
    cases = []
    o, d = np.array([0.0, 0.0, -5.0], np.float32), np.array([0.0, 0.0, 1.0], np.float32)
    unit = ([-1, -1, -1], [1, 1, 1])
    cases.append((unit, o, 1.0 / np.where(d == 0, 1e-30, d)))
    cases.append((unit, o, np.array([np.inf, np.inf, -1.0], np.float32)))
    cases.append((unit, np.array([5.0, 0.0, -5.0], np.float32), np.array([np.inf, np.inf, 1.0],
                                                                          np.float32)))
    cases.append((unit, o, np.where(np.abs(d) > 1e-20, 1.0 / np.where(d == 0, 1, d),
                                    1e20).astype(np.float32)))
    cases.append((([[-1, -1, 4], [3, 3, 3]], [[1, 1, 6], [4, 4, 4]]),
                  np.zeros(3, np.float32), 1.0 / np.array([1e-9, 1e-9, 1.0], np.float32)))
    r = np.random.default_rng(5)
    lo = r.uniform(-2, 1, (1000, 3)).astype(np.float32)
    cases.append(((lo, lo + r.uniform(0.1, 2, (1000, 3)).astype(np.float32)),
                  r.uniform(-4, 4, (1000, 3)).astype(np.float32),
                  1.0 / r.normal(size=(1000, 3)).astype(np.float32)))
    for (mn, mx), oo, inv in cases:
        jb, tb = _boxes(np.asarray(mn, np.float32), np.asarray(mx, np.float32))
        want = np.asarray(jaabb.hit(jb, jnp.asarray(oo), jnp.asarray(inv), 1e-3, 1e30))
        got = aabb.hit(tb, oo, inv, 1e-3, 1e30).numpy()
        np.testing.assert_array_equal(got, want)
    assert got.shape == (1000,) and 0 < got.sum() < 1000


def test_bvh_depth_stats_matches_jax():
    """On the teapot's BVH: the port's stats of its own build equal JAX's
    of JAX's build."""
    jb = jax_build_scene(3)
    a, b, c = (np.array(x) for x in (jb.scene.tri_a, jb.scene.tri_b, jb.scene.tri_c))
    want = jax_bvh_depth_stats(jax_build_tri_bvh(a, b, c))
    got = bvh_depth_stats(build_tri_bvh(a, b, c))
    assert got == want
    assert got["max_leaf_size"] <= 4 and got["n_leaves"] * 2 - 1 == got["n_nodes"]
    assert 10 <= got["max_depth"] < 64


def test_random_in_unit_sphere_matches_jax():
    r = np.random.default_rng(9)
    u = r.random((3, 10000), dtype=np.float32)
    want = np.asarray(jax_random_in_unit_sphere(*map(jnp.asarray, u)))
    got = trng.random_in_unit_sphere(*map(torch.from_numpy, u))
    assert got.shape == (10000, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    radius = np.linalg.norm(got.numpy(), axis=-1)
    assert radius.max() < 1.0 + 1e-6
    # the volumetric density: P(|x| < 1/2) = 1/8
    assert abs((radius < 0.5).mean() - 0.125) < 0.01
