"""The four-card cell ``threeBalls.render_sharded4`` on the host at cut
sizes: its driver's gloo ranks on the CPU run and check, the control and
a fault in one rank's slice fail the check, its readers on planted
records, and its ranks' card records reaching the ``device`` block."""

from __future__ import annotations

import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark import cards, control, run
from benchmark.drivers import render_sharded as driver
from benchmark.tests.conftest import REPO, TINY

CELL = "threeBalls.render_sharded4"
H100 = "NVIDIA H100 80GB HBM3"


def _correct(cell, numbers: dict) -> bool:
    return all(v == v and v <= cell.limits[k] for k, v in numbers.items())


@pytest.fixture
def root(root):
    """The cut root, the cell's traffic cut as the ``render`` kind's is:
    every path of the first checked image counted."""
    path = root / "benchmark" / "traffic" / "render_sharded4.json"
    tr = json.loads(path.read_text())
    tr.update(check=dict(pixels=64, images=2, event_samples=TINY["render"]["spp"]),
              profile_images=2)
    path.write_text(json.dumps(tr))
    return root


@pytest.mark.parametrize("trace", [False, True])
def test_cell_runs_and_checks_on_four_host_ranks(trace, root):
    out = run.run_cell(run.load_cell(root, CELL), 4_000_000_007, 0.2, trace, ["cpu"])
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    if trace:  # the host has no card: the readers find nothing
        assert out["metrics"] == {} and set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(out["metrics"]) == {"rays_per_s", "image_p95_ms", "setup_s"}


def test_control_is_not_correct(root):
    cell = run.load_cell(root, CELL)
    r = control.readings(cell, 6_000_000_001, 0.1, ["cpu"])
    assert _correct(cell, r["program"])
    assert not _correct(cell, {k: float("nan") if v is None else v
                               for k, v in r["control"].items()})


def _zeroed_rank(rank, world, job):
    """The driver's rank, with rank 1's slot sums zeroed where they are
    traced (its slice of the image lost)."""
    if rank == 1:
        from zraytrace_tpu_torch import render

        orig = render.trace_route

        def zeroed(*a, **k):
            sums, counters = orig(*a, **k)
            return sums * 0, counters

        render.trace_route = zeroed
    return driver._rank(rank, world, job)


def test_one_rank_slice_zeroed_is_not_correct(root, monkeypatch):
    cell = run.load_cell(root, CELL)
    monkeypatch.setattr(driver, "_rank", _zeroed_rank)
    run.hand(cell, 7_000_000_003, 0.2, False, ["cpu"])
    numbers = driver.run(cell)["check"]()
    assert numbers["image_gap"] > cell.limits["image_gap"] or \
        numbers["identity_misses"] > cell.limits["identity_misses"]


def _uuid(i: int) -> str:
    return f"GPU-00000000-0000-0000-0000-{i:012d}"


def _profile(rank, kernel_ms, images=2):
    """A rank's traced pass, ``images`` images whose kernel ran
    ``kernel_ms`` each, busy half its window."""
    k = kernel_ms * images / 1e3
    return dict(busy_s=k, busy_by_card={rank: k}, window_s=2 * k, device_ops=3 * images,
                kernels={"bounce_kernel(float*)": k, "Memcpy DtoH": 0.001},
                kernel_counts={"bounce_kernel(float*)": images, "Memcpy DtoH": 2 * images},
                breakdown=dict(device_ops=[["bounce_kernel(float*)", k], ["Memcpy DtoH", 0.001]],
                               idle_gaps=[["aten::div", 0.002], ["no host operation", 0.001]]))


def _build(seconds):
    from zraytrace_tpu_torch.profiling import Record

    rec = Record("scene.build", 1.0, False)
    rec.seconds = seconds
    return rec


def _planted_ranks(trace_ms, allreduce_ms, host_ms, profiled=False, kernel_ms=(1, 2, 3, 4)):
    """Four ranks' outputs as the driver's ranks return them: per rank one
    warm-up record before set-up, the window's records (``trace_ms[i][r]``
    for image i on rank r), and a profiled record after, its traced pass
    (``kernel_ms[r]`` an image) and its scene build (``r + 1`` s); rank 0
    with one window image."""
    outs = []
    for r in range(4):
        recs = [dict(started=0.0, profiled=False, counters={},
                     spans={"mesh.trace": 9.0, "mesh.allreduce": 9.0})]
        for i, row in enumerate(trace_ms):
            recs.append(dict(started=10.0 + i, profiled=profiled, counters={}, spans={
                "mesh.trace": row[r] / 1e3, "mesh.allreduce": allreduce_ms[i][r] / 1e3,
                "mesh.prepare": host_ms / 3e3, "mesh.fetch": host_ms / 3e3,
                "mesh.divide": host_ms / 3e3}))
        recs.append(dict(started=99.0, profiled=True, counters={},
                         spans={"mesh.trace": 9.0, "mesh.allreduce": 9.0}))
        out = dict(records=(5.0, recs), forbidden=[], profile=_profile(r, kernel_ms[r]),
                   builds=[_build(r + 1.0)],
                   device=dict(index=r, uuid=_uuid(r), name=H100, peak_bytes=1000 + r))
        if r == 0:
            out.update(setup_end=5.0, window_s=1.0, profiled_images=[
                dict(rays=10, reflections=4, background_hits=6, recursion_depth_hits=0,
                     samples=6)] * 2, images=[dict(
                seed=1, seconds=0.03, values=np.zeros((64, 3), np.float32), rays=10, reflections=4,
                background_hits=6, recursion_depth_hits=0, samples=6, ok=True)])
        outs.append(out)
    return outs


def _read(res, name):
    return run.reader(REPO, name)(res)


NAMES = ("sharded_trace_ms", "sharded_balance_pct", "sharded_collective_ms", "sharded_host_ms")


def _planted_res(outs):
    return dict(cell=SimpleNamespace(device=torch.device("cuda", 0),
                                     config=dict(work=dict(kernel="bounce_kernel"))),
                ranks=[o["records"] for o in outs], rank_profiles=[o["profile"] for o in outs],
                profiled_images=outs[0]["profiled_images"])


def test_readers_on_planted_records():
    res = _planted_res(_planted_ranks(trace_ms=[[10, 20, 30, 40], [40, 40, 40, 40]],
                                      allreduce_ms=[[5, 4, 3, 2], [1, 1, 1, 1]], host_ms=3.0,
                                      kernel_ms=(10, 20, 30, 40)))
    assert _read(res, "sharded_trace_ms") == pytest.approx(40.0)
    assert _read(res, "sharded_balance_pct") == pytest.approx(62.5)
    assert _read(res, "sharded_collective_ms") == pytest.approx((2.0 + 1.0) / 2)
    assert _read(res, "sharded_host_ms") == pytest.approx(3.0)
    # off the card, without the ranks' records and profiles (a program
    # without the spans, an untraced run), with every window record
    # profiled, or a rank whose trace lacks the kernel: nothing
    outs = _planted_ranks([[1, 1, 1, 1]], [[1, 1, 1, 1]], 1.0, profiled=True)
    outs[2]["profile"]["kernels"] = {"Memcpy DtoH": 0.001}
    for r in (dict(res, cell=SimpleNamespace(device=torch.device("cpu"))),
              dict(res, ranks=None, rank_profiles=None),
              _planted_res(outs),
              dict(res, ranks=[(5.0, [dict(started=10.0, profiled=False, counters={},
                                           spans={"render.render": 1.0})])] * 4,
                   rank_profiles=[None] * 4)):
        assert [_read(r, n) for n in NAMES] == [None] * 4


def test_the_ranks_profiles_merge_over_the_cards():
    """Busy and window seconds and the kernels summed over the four cards,
    so ``device_idle_pct.render`` is the idle share of all the card time
    and ``bounce_roofline`` prices the whole images' work against every
    card's kernel seconds."""
    from benchmark import roofline

    outs = _planted_ranks([[1, 1, 1, 1]], [[1, 1, 1, 1]], 1.0, kernel_ms=(10, 20, 30, 40))
    prof = driver.merged([o["profile"] for o in outs])
    assert prof["busy_s"] == pytest.approx(0.2) and prof["window_s"] == pytest.approx(0.4)
    assert prof["busy_by_card"] == pytest.approx({0: 0.02, 1: 0.04, 2: 0.06, 3: 0.08})
    assert prof["kernels"]["bounce_kernel(float*)"] == pytest.approx(0.2)
    assert prof["kernel_counts"] == {"bounce_kernel(float*)": 8, "Memcpy DtoH": 16}
    assert prof["breakdown"]["idle_gaps"] == [["aten::div", pytest.approx(0.008)],
                                              ["no host operation", pytest.approx(0.004)]]
    cell = run.load_cell(REPO, CELL)
    cell.device = torch.device("cuda", 0)
    res = dict(cell=cell, profile=prof, profiled_images=outs[0]["profiled_images"],
               width=1000, height=1000)
    assert _read(res, "device_idle_pct.render") == pytest.approx(50.0)
    work = cell.config["work"]
    least = 2 * roofline.least_seconds(roofline.image_ops(work, outs[0]["profiled_images"][0]),
                                       roofline.image_bytes(work, 1000, 1000))
    assert _read(res, "bounce_roofline") == pytest.approx(100.0 * least / 0.2)


def test_ranks_card_records_reach_the_device_block(root, monkeypatch):
    """The driver's ``devices``, one record a rank, count four cards; the
    longest rank's scene build is kept here, where ``setup_scene_s``
    reads it."""
    from zraytrace_tpu_torch import profiling
    from zraytrace_tpu_torch.parallel import multihost

    monkeypatch.setattr(multihost, "run_ranks", lambda *a, **k: _planted_ranks(
        [[1, 2, 3, 4]], [[1, 1, 1, 1]], 1.0))
    monkeypatch.setattr(cards, "smi", lambda field, card: "700.00 W")
    cell = run.load_cell(root, CELL)
    run.hand(cell, 1, 0.1, False, [torch.device("cuda", i) for i in range(4)])
    profiling.reset()
    try:
        res = driver.run(cell)
        assert _read(dict(res, cell=cell), "setup_scene_s") == 4.0
    finally:
        profiling.reset()
    dev = cards.block(res["devices"], res["devices"], cell.entry["chips"], False)
    assert dev["count"] == 4 and dev["cards"] == [[i, _uuid(i)] for i in range(4)]
    assert dev["memory_peak_bytes"] == 1003 and dev["power_limit"] == ["700.00 W"] * 4
    assert res["metrics"]["rays_per_s"] == 10.0


def test_the_configuration_is_threeBalls_over_four_cards():
    """``threeBalls_node4`` renders ``threeBalls``'s image: its precision,
    render, scenes and work are copied whole, and its mesh's ranks are the
    cell's cards, one a card."""
    configs = REPO / "benchmark" / "configs"
    own = json.loads((configs / "threeBalls_node4.json").read_text())
    base = json.loads((configs / "threeBalls.json").read_text())
    assert {k: own[k] for k in ("precision", "render", "scenes", "work")} == \
        {k: base[k] for k in ("precision", "render", "scenes", "work")}
    cell = run.load_cell(REPO, CELL)
    cluster = cell.config["cluster"]
    assert cluster["mesh"]["data"] * cluster["mesh"]["sample"] == cluster["cards"] \
        == cell.entry["chips"] and cluster["ranks_per_card"] == 1


def test_too_few_handed_cards_start_no_rank(root, monkeypatch):
    from zraytrace_tpu_torch.parallel import multihost

    def started(*a, **k):
        raise AssertionError("a rank was started")

    monkeypatch.setattr(multihost, "run_ranks", started)
    cell = run.load_cell(root, CELL)
    run.hand(cell, 1, 0.1, False, [torch.device("cuda", i) for i in range(2)])
    with pytest.raises(RuntimeError, match="4 ranks, one a card, were handed 2 cards"):
        driver.run(cell)
