"""The port's span and counter store (``zraytrace_tpu_torch.profiling``) on
the CPU: nesting and self time, the per-call records and their bound,
recompute inside a backward pass, the profiler's ranges, the spans of
``render()`` and of the differentiable frame, and the benchmark's readers
of them (``benchmark/metrics/_spans.py``)."""

from __future__ import annotations

import time
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch
from torch.utils.checkpoint import checkpoint

from benchmark import run as bench_run
from zraytrace_tpu_torch import RenderParams, profiling
from zraytrace_tpu_torch import kernel_inputs as ki
from zraytrace_tpu_torch.geometry.bvh import build_tri_bvh
from zraytrace_tpu_torch.inverse import fit, make_loss_fn, split_scene
from zraytrace_tpu_torch.profiling import count, counter, records, reset, span, totals
from zraytrace_tpu_torch.render import render
from zraytrace_tpu_torch.scenes import teapot_on_ground, three_balls

REPO = Path(__file__).resolve().parents[1]
READERS = ("render_route_ms", "render_fetch_ms", "render_divide_ms", "fit_winner_s",
           "fit_intersect_s", "fit_edge_s", "fit_shade_s", "fit_recompute_s", "setup_scene_s")
# the spans of one bounce in both passes, and of the passes before it
BOUNCE = ("diff.bounce", "diff.intersect", "diff.edge")
SIZE = dict(width=8, height=8, spp=1, depth=2)


@pytest.fixture(autouse=True)
def empty_store():
    reset()
    yield
    reset()


@pytest.fixture(scope="module")
def balls():
    return three_balls("cpu")


@pytest.fixture(scope="module")
def teapot():
    b = teapot_on_ground("cpu")
    return b, build_tri_bvh(b.scene.tri_a, b.scene.tri_b, b.scene.tri_c).prim_order


def sphere_loss(balls):
    """A tiny albedo fit's loss, as the benchmark builds it, and its leaves."""
    params, static = split_scene(balls.scene)
    live = {f: params[f].detach().clone().requires_grad_(True)
            for f in ("sph_center", "sph_radius", "tex_color")}
    frozen = {**static, **{f: v for f, v in params.items() if f not in live}}
    target = torch.zeros((8, 8, 3))
    loss_fn = make_loss_fn(frozen, balls.camera, target, 8, 8, 1, 2, 7, edge_eps=(0.01, 0.02))
    return loss_fn, live


def pose_step(teapot):
    """One pose-fit step's loss and backward on the teapot, its planes
    passed, so the winner pass and the margin selection run their plain
    versions."""
    b, order = teapot
    off = torch.tensor([0.05, -0.02, 0.03], requires_grad=True)
    target = torch.zeros((8, 8, 3))
    ki.pose_loss(b.scene, b.camera, order, off, target, **SIZE).backward()
    return off


def test_nested_spans_sum_by_name_with_self_time():
    with span("outer") as outer:
        for _ in range(2):
            with span("inner"):
                time.sleep(0.002)
        time.sleep(0.002)
    got = totals()
    assert list(got) == [("inner", False), ("outer", False)]
    o, i = got[("outer", False)], got[("inner", False)]
    assert (o.calls, i.calls) == (1, 2)
    assert o.seconds == outer.seconds >= i.seconds >= 0.004
    assert o.self_seconds == pytest.approx(o.seconds - i.seconds, rel=1e-9)
    assert i.self_seconds == i.seconds


def test_a_span_as_decorator_times_each_call():
    @span("work")
    def work(x):
        return x + 1

    assert work(1) == 2 and work(2) == 3
    assert totals()[("work", False)].calls == 2
    assert len(records("work")) == 2


def test_outermost_span_opens_a_record_and_the_newest_takes_counters():
    with span("a"):
        with span("b"):
            count("hits", 2)
    count("hits")  # outside any span: the newest record still takes it
    with span("a"):
        count("hits", 5)
    recs = records("a")
    assert len(recs) == 2 and not records("b")
    assert recs[0].counters == {"hits": 3} and recs[1].counters == {"hits": 5}
    assert recs[0].stat("b").calls == 1 and recs[1].stat("b") is None
    assert recs[0].root == "a" and recs[0].seconds == recs[0].stat("a").seconds
    assert counter("hits") == 8 and counter("misses") == 0


def test_records_are_bounded_per_root():
    n = profiling.RECORDS_PER_ROOT + 44
    for k in range(n):
        with span("image"):
            count("index", k)
    with span("other"):
        pass
    kept = records("image")
    assert len(kept) == profiling.RECORDS_PER_ROOT
    assert [r.counters.get("index", 0) for r in kept] == list(range(44, n))
    assert len(records("other")) == 1


def test_checkpoint_recompute_is_marked_and_opens_no_record():
    def body(x):
        with span("part"):
            return (x * 2.0).sin()

    x = torch.ones(4, requires_grad=True)
    with span("step"):
        y = checkpoint(body, x, use_reentrant=False)
    y.sum().backward()
    got = totals()
    assert got[("part", False)].calls == 1 and got[("part", True)].calls == 1
    (rec,) = records("step")
    assert rec.stat("part", recompute=True).calls == 1
    assert rec.recompute_seconds == rec.stat("part", recompute=True).seconds > 0
    assert not records("part")


def test_no_record_function_without_a_profiler(monkeypatch):
    entered = []

    class Spy(torch.profiler.record_function):
        def __enter__(self):
            entered.append(self.name)
            return super().__enter__()

    monkeypatch.setattr(torch.profiler, "record_function", Spy)
    with span("quiet"):
        pass
    assert entered == []
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]):
        with span("loud"):
            pass
    assert entered == ["loud"]


def test_spans_are_user_annotations_under_the_profiler(balls):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        render(balls.scene, balls.camera, RenderParams(8, 6, 1, 2), "cpu")
    names = {e.name() for e in prof.profiler.kineto_results.events() if e.is_user_annotation()}
    assert {"render.render", "render.prepare", "render.route", "render.launch", "render.wait",
            "render.fetch", "render.divide"} <= names


def test_render_fills_its_spans_and_stats_read_them(balls):
    img, st = render(balls.scene, balls.camera, RenderParams(8, 6, 1, 2), "cpu")
    assert img.shape == (6, 8, 3)
    (rec,) = records("render.render")
    sec = {n: rec.stat(f"render.{n}").seconds
           for n in ("prepare", "route", "launch", "wait", "fetch", "divide")}
    assert st.preprocess_seconds == sec["prepare"] + sec["route"]
    assert st.render_seconds == sec["launch"] + sec["wait"]
    assert st.transfer_seconds == sec["fetch"] + sec["divide"]
    assert rec.stat("render.render").self_seconds < rec.seconds


def test_sphere_fit_step_fills_the_bounce_spans_and_their_recompute(balls):
    loss_fn, live = sphere_loss(balls)
    loss_fn(live).backward()
    (rec,) = records("fit.loss")
    assert rec.stat("diff.sample").calls == 1  # spp 1
    for name in BOUNCE:
        assert rec.stat(name).calls == 2, name  # depth 2
        assert rec.stat(name, recompute=True).calls == 2, name
    # no triangles: neither no-grad pass runs
    assert rec.stat("diff.winner") is None and rec.stat("diff.margins") is None
    assert rec.recompute_seconds == pytest.approx(
        rec.stat("diff.bounce", recompute=True).seconds, rel=1e-9)


def test_mesh_fit_step_fills_every_diff_span(teapot):
    off = pose_step(teapot)
    assert off.grad is not None and bool(torch.isfinite(off.grad).all())
    (rec,) = records("fit.loss")
    assert rec.stat("diff.pack").calls == 1
    for name in ("diff.winner", "diff.margins") + BOUNCE:
        assert rec.stat(name).calls == 2, name
    for name in BOUNCE:
        assert rec.stat(name, recompute=True).calls == 2, name
    assert rec.stat("diff.winner", recompute=True) is None  # no-grad: never recomputed
    assert counter("launch.flash") == counter("launch.margins") == 0  # the CPU's plain paths


def test_inverse_fit_steps_are_spans(balls):
    fit(balls.scene, balls.camera, torch.zeros((8, 8, 3)), 8, 8, spp=1, max_depth=2, steps=2,
        optimize_fields=("sph_center",), edge_eps=0.01, device="cpu")
    recs = records("fit.step")
    assert len(recs) == 2
    for rec in recs:
        for name in ("fit.loss", "fit.backward", "fit.adam"):
            assert rec.stat(name).calls == 1, name
        assert rec.stat("diff.bounce", recompute=True).calls == 2
        assert rec.stat("fit.checkpoint") is None
    assert not records("fit.loss")


def test_scene_build_holds_its_reads():
    three_balls("cpu")
    (rec,) = records("scene.build")
    assert rec.stat("io.png").calls == 2  # the two textures
    assert rec.stat("scene.build").self_seconds < rec.seconds


def _build_in_rank(rank, world):
    from zraytrace_tpu_torch import profiling

    three_balls("cpu")
    return profiling.records("scene.build")


def test_a_ranks_record_is_kept_in_the_launching_process():
    """A rank's ``scene.build`` record, returned through ``run_ranks``
    and kept, reads here as one of this process's, spans and all."""
    from zraytrace_tpu_torch.parallel.multihost import run_ranks
    from zraytrace_tpu_torch.profiling import keep

    (rec,) = run_ranks(_build_in_rank, 1, timeout=120)[0]
    assert not records("scene.build")
    keep(rec)
    (kept,) = records("scene.build")
    assert kept.seconds == rec.seconds > 0 and kept.stat("io.png").calls == 2


def _read(name, setup_end, device="cuda"):
    """The benchmark's reader ``name`` on a traced run on ``device`` whose
    set-up ended at ``setup_end``: the readers take only runs on the
    card, so the host's store stands in."""
    run = {"cell": SimpleNamespace(device=device), "setup_end": setup_end}
    return bench_run.reader(REPO, name)(run)


@pytest.mark.parametrize("name", READERS)
def test_each_reader_reads_the_store(name, balls, teapot):
    assert _read(name, 0.0) is None  # an empty store: nothing to read
    teapot_on_ground("cpu")
    setup_end = time.perf_counter()
    render(balls.scene, balls.camera, RenderParams(8, 6, 1, 2), "cpu")
    pose_step(teapot)
    value = _read(name, setup_end)
    assert isinstance(value, float) and value >= 0.0
    assert _read(name, setup_end, device="cpu") is None


def test_the_fit_readers_read_a_sphere_step_without_its_winner(balls):
    setup_end = time.perf_counter()
    loss_fn, live = sphere_loss(balls)
    loss_fn(live).backward()
    assert _read("fit_winner_s", setup_end) is None
    assert all(_read(n, setup_end) > 0 for n in ("fit_intersect_s", "fit_edge_s",
                                                 "fit_shade_s", "fit_recompute_s"))
    assert _read("render_fetch_ms", setup_end) is None
    assert _read("setup_scene_s", setup_end) is None  # no scene built in set-up


def _step(sleep_s):
    with span("fit.loss"):
        with span("diff.bounce"):
            with span("diff.intersect"):
                time.sleep(sleep_s)


def test_the_readers_average_the_windows_records_alone():
    """Set-up's records and those made under the profiler are left out;
    the window's are averaged."""
    from torch.profiler import ProfilerActivity, profile

    _step(0.02)  # the start step, in set-up
    setup_end = time.perf_counter()
    for k in (1.0, 2.0, 6.0):
        _step(0.001 * k)
    with profile(activities=[ProfilerActivity.CPU]):
        _step(0.02)
    (profiled,) = [r for r in records("fit.loss") if r.profiled]
    assert profiled.started > setup_end
    got = _read("fit_intersect_s", setup_end)
    assert 0.003 <= got < 0.006
