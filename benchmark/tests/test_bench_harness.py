"""The harness on the host at cut sizes: every cell runs and checks, data
files are found by name, the window's arithmetic, the import guard, the
exits without a card, and the cards a run is counted as using (stub
drivers and cards faked on the host; one test spawns a rank on each
visible card)."""

from __future__ import annotations

import json
import multiprocessing
import os
import shutil
import subprocess
import sys
import time
from types import SimpleNamespace

import pytest
import torch

from benchmark import cards, devtrace, roofline, run
from benchmark.drivers import closed_loop
from benchmark.drivers.render import window_metrics
from benchmark.tests.conftest import REPO

CELLS = ["threeBalls.render", "teapot.render", "threeBalls.albedo_fit", "teapot.pose_fit"]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_and_checks_on_the_host(cell, root):
    out = run.run_cell(run.load_cell(root, cell), 4_000_000_007, 0.2, False, ["cpu"])
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    want = {m["name"] for m in bench["end_to_end"] if cell in m.get("workloads", [cell])}
    assert set(out["metrics"]) == want
    assert list(out)[-1] == "checks"


def test_traced_run_reads_its_per_layer_metrics(root):
    out = run.run_cell(run.load_cell(root, "threeBalls.render"), 5, 0.2, True, ["cpu"])
    # the host has no device trace: the device's readers find nothing
    assert set(out["metrics"]) == {"render_host_ms"}
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert out["device"]["window_s"] > 0


def test_new_config_traffic_and_metric_are_found_by_name(root):
    here = root / "benchmark"
    cfg = json.loads((here / "configs" / "threeBalls.json").read_text())
    cfg["render"].update(width=6, height=4)
    (here / "configs" / "smallBalls.json").write_text(json.dumps(cfg))
    tr = json.loads((here / "traffic" / "render.json").read_text())
    tr["check"] = dict(pixels=24, images=1, event_samples=2)
    (here / "traffic" / "render_once.json").write_text(json.dumps(tr))
    (here / "metrics" / "images_per_window.py").write_text(
        "def read(run):\n    return float(len(run['images']))\n")
    (here / "limits" / "smallBalls.render_once.json").write_text(
        (here / "limits" / "threeBalls.render.json").read_text())
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append(dict(name="smallBalls.render_once", config="smallBalls",
                                   traffic="render_once", chips=1, why="a test cell"))
    bench["per_layer"].append(dict(name="images_per_window", unit="images", better="higher",
                                   source="host_clock", layer="entry point", moves="rays_per_s",
                                   workloads=["smallBalls.render_once"]))
    for m in bench["end_to_end"]:
        if "workloads" in m and "threeBalls.render" in m["workloads"]:
            m["workloads"].append("smallBalls.render_once")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    out = run.run_cell(run.load_cell(root, "smallBalls.render_once"), 9, 0.2, True, ["cpu"])
    assert out["correct"]
    assert out["metrics"]["images_per_window"]["value"] >= 1


def test_window_runs_whole_calls_past_its_length():
    calls = []

    def fn(i):
        time.sleep(0.03)
        calls.append(i)
        return i

    out, window = closed_loop(fn, 0.1, "cpu")
    assert out == calls == list(range(len(out)))
    assert window >= 0.1 and len(out) >= 3


def test_window_metrics_take_all_images_and_all_seconds():
    images = [dict(rays=100, seconds=s / 1000.0) for s in range(1, 101)]
    m = window_metrics(images, 4.0)
    assert m["rays_per_s"] == 100 * 100 / 4.0
    assert m["image_p95_ms"] == pytest.approx(95.05)


def test_roofline_arithmetic():
    work = dict(ops_per_event=dict(samples=34, background_hits=-45, rays=190.0),
                table_bytes=1000)
    c = dict(samples=10, background_hits=4, rays=20)
    assert roofline.image_ops(work, c) == 340 - 180 + 3800
    assert roofline.image_bytes(work, 4, 2) == 1000 + 12 * 8
    assert roofline.least_seconds(67e12, 1.0) == 1.0
    assert roofline.least_seconds(1.0, 3.35e12) == 1.0


def test_kernel_readers_on_a_canned_trace():
    def read(name, r):
        return run.reader(REPO, name)(r)

    cfg = json.loads((REPO / "benchmark" / "configs" / "threeBalls.json").read_text())
    cell = run.SimpleNamespace(config=cfg)
    im = dict(samples=10**9, background_hits=10**9, rays=2 * 10**9, reflections=10**9,
              recursion_depth_hits=0, preprocess_s=0.001, transfer_s=0.003)
    ops = roofline.image_ops(cfg["work"], im)
    least = roofline.least_seconds(ops, roofline.image_bytes(cfg["work"], 1000, 1000))
    r = dict(cell=cell, width=1000, height=1000, images=[im, im], window_s=2.0,
             profiled_images=[im], profiled_steps=2,
             profile=dict(busy_s=0.9, window_s=1.0, device_ops=50,
                          kernels={"void bounce_kernel<false, false>(...)": 2 * least,
                                   "Memcpy DtoH": 1.0}))
    assert read("bounce_roofline", r) == pytest.approx(50.0)
    assert read("device_idle_pct.render", r) == pytest.approx(10.0)
    assert read("render_host_ms", r) == pytest.approx(4.0)
    assert read("fit_device_ops_per_step", r) == 25.0
    r["profile"]["kernels"] = {"Memcpy DtoH": 1.0}
    assert read("bounce_roofline", r) is None


def test_forbidden_modules_compare_top_level_names_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "zraytrace_tpu_torch_lookalike", sys)
    assert "zraytrace_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "zraytrace_tpu.render", sys)
    assert "zraytrace_tpu" in run.forbidden_modules()


def _python(code, cwd=REPO, env=None):
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, capture_output=True, text=True,
                          timeout=600, env=env)


def test_a_run_imports_no_jax_and_the_reference_none_of_the_program(tmp_path):
    from benchmark.tests.conftest import tiny_root

    root = tiny_root(tmp_path)
    code = f"""
import sys, pathlib
from benchmark import run, control, pricing
from benchmark.reference import common, diff, render, scene
assert not [m for m in sys.modules if m.split('.')[0] == 'zraytrace_tpu_torch'], 'reference'
for cell in {CELLS!r}:
    run.run_cell(run.load_cell(pathlib.Path({str(root)!r}), cell), 11, 0.1,
                 cell.endswith('render'), ['cpu'])
print(run.forbidden_modules())
"""
    out = _python(code)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_no_card_exits_nonzero_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                          "threeBalls.render", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=REPO, capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode != 0 and out.stdout == ""


def test_a_directory_of_the_benchmark_alone_exits_nonzero(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                          "threeBalls.render", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""


H100 = "NVIDIA H100 80GB HBM3"


def _uuid(i: int) -> str:
    return f"00000000-0000-0000-0000-{i:012d}"


def _fake_cards(monkeypatch, peaks: dict) -> list:
    """CUDA cards faked on the host: card ``i`` with UUID ``_uuid(i)``, an
    H100's name, ``peaks[i]`` bytes allocated at the most in this process
    and a power limit of 700 W; returns the cards ``nvidia-smi`` was asked
    about."""
    asked = []

    def smi(cmd, **_):
        asked.append(cmd[cmd.index("-i") + 1])
        return SimpleNamespace(returncode=0, stdout="700.00 W\n")

    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda i: SimpleNamespace(uuid=_uuid(i), name=H100))
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda i: peaks.get(i, 0))
    monkeypatch.setattr(cards.subprocess, "run", smi)
    return asked


def _stub_driver(monkeypatch, records=None):
    """A driver whose run does no work and returns ``records`` as its
    ranks' (none: the harness records the handed cards itself); a traced
    run's profile reads 0.5 s busy on card 0 in a 2 s window."""

    def run_(cell):
        res = dict(setup_end=run.T_START, window_s=1.0, attempted=1, failed=0,
                   metrics=dict(rays_per_s=1.0, image_p95_ms=1.0), check=lambda: {})
        if records is not None:
            res["devices"] = records
        if cell.trace:
            res["profile"] = dict(busy_s=0.5, busy_by_card={0: 0.5}, window_s=2.0,
                                  breakdown=dict(device_ops=[], idle_gaps=[]))
        return res

    monkeypatch.setattr(run, "driver", lambda kind: SimpleNamespace(run=run_))
    monkeypatch.setattr(run, "reader", lambda root, name: lambda r: None)


def _four_cards():
    return [torch.device("cuda", i) for i in range(4)]


@pytest.mark.parametrize("trace", [False, True])
def test_four_rank_records_count_four_cards_and_the_fullest_peak(trace, root, monkeypatch):
    asked = _fake_cards(monkeypatch, {})
    peaks = [10, 40, 20, 30]
    records = [dict(index=i, uuid=f"GPU-{_uuid(i)}", name=H100, peak_bytes=p, busy_s=0.25 * i,
                    window_s=2.0) for i, p in enumerate(peaks)]
    _stub_driver(monkeypatch, records)
    cell = run.load_cell(root, "threeBalls.render")
    cell.entry["chips"] = 4
    dev = run.run_cell(cell, 1, 0.1, trace, _four_cards())["device"]
    assert dev["count"] == 4 and dev["kind"] == H100
    assert dev["memory_peak_bytes"] == 40 and dev["memory_peak_bytes_per_card"] == peaks
    assert dev["power_limit"] == ["700.00 W"] * 4
    assert asked == [f"GPU-{_uuid(i)}" for i in range(4)]
    if trace:
        assert dev["busy_s"] == 1.5 and dev["window_s"] == 8.0
        assert dev["busy_s_per_card"] == [0.0, 0.25, 0.5, 0.75]


def _wrong_cards(monkeypatch):
    """Four records of ranks that all sat on card 0."""
    _fake_cards(monkeypatch, {})
    _stub_driver(monkeypatch, [dict(index=0, uuid=f"GPU-{_uuid(0)}", name=H100, peak_bytes=10)
                               for _ in range(4)])


def _one_of_four_in_process(monkeypatch):
    """A driver in this process that used the first of four handed cards."""
    _fake_cards(monkeypatch, {0: 10})
    _stub_driver(monkeypatch)


@pytest.mark.parametrize("plant", [_wrong_cards, _one_of_four_in_process])
def test_fewer_distinct_cards_than_chips_exit_5_with_no_result(plant, root, monkeypatch, capsys):
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        w["chips"] = 4
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    monkeypatch.setattr(run, "ROOT", root)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    plant(monkeypatch)
    rc = run.main(["--workload", "threeBalls.render", "--seed", "1", "--seconds", "0.1"])
    out = capsys.readouterr()
    assert rc == 5 and out.out == ""
    assert "handed cuda:0 GPU-" in out.err and f"cuda:3 GPU-{_uuid(3)}" in out.err
    assert f"used cuda:0 GPU-{_uuid(0)}" in out.err


@pytest.mark.parametrize("trace", [False, True])
def test_one_card_in_process_keeps_the_device_block(trace, root, monkeypatch):
    asked = _fake_cards(monkeypatch, {0: 123456})
    _stub_driver(monkeypatch)
    dev = run.run_cell(run.load_cell(root, "threeBalls.render"), 1, 0.1, trace,
                       [torch.device("cuda", 0)])["device"]
    before = dict(platform="gpu", kind=H100, count=1, power_limit="700.00 W",
                  memory_peak_bytes=123456)
    if trace:
        before.update(busy_s=0.5, window_s=2.0)
    assert {k: dev[k] for k in before} == before
    assert asked == [f"GPU-{_uuid(0)}"]
    assert dev["memory_peak_bytes_per_card"] == [123456]
    assert dev["cards"] == [[0, f"GPU-{_uuid(0)}"]]
    assert set(dev["host_cpu"]) == {"model", "cpuid", "mhz", "cpus"}
    assert dev["host_cpu"]["cpus"] >= 1


def test_a_card_without_a_uuid_field_is_asked_of_nvidia_smi_by_its_pci_address(monkeypatch):
    asked = _fake_cards(monkeypatch, {})
    assert cards.uuid(SimpleNamespace(uuid=_uuid(7))) == f"GPU-{_uuid(7)}"
    assert cards.uuid(SimpleNamespace(pci_domain_id=0, pci_bus_id=25, pci_device_id=0)) \
        == "700.00 W"  # the fake nvidia-smi's one answer
    assert asked == ["00000000:19:00.0"]


def test_trace_reduction_splits_busy_seconds_by_card():
    ms = 1_000_000
    device = [("k", 0, 4 * ms, 0), ("k", 2 * ms, 6 * ms, 0), ("k", 1 * ms, 3 * ms, 1)]
    host = [("aten::op", 0, 8 * ms)]
    r = devtrace.reduce_trace(device, host, 0.008)
    assert r["busy_by_card"] == pytest.approx({0: 0.006, 1: 0.002})
    assert r["busy_s"] == pytest.approx(0.006)


def _rank_record(index: int) -> dict:
    """A rank's record of its own card, taken in the rank's process."""
    x = torch.ones(1 << 20, device=torch.device("cuda", index))
    torch.cuda.synchronize(index)
    rec = cards.record(x.device)
    del x
    return rec


@pytest.mark.gpu
def test_a_rank_on_every_visible_card_is_counted(root, monkeypatch):
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 2:
        pytest.skip("needs 2 or more CUDA devices")

    def run_(cell):
        with multiprocessing.get_context("spawn").Pool(len(cell.devices)) as pool:
            records = pool.map(_rank_record, [d.index for d in cell.devices])
        return dict(setup_end=run.T_START, window_s=1.0, attempted=1, failed=0,
                    metrics=dict(rays_per_s=1.0, image_p95_ms=1.0), check=lambda: {},
                    devices=records)

    monkeypatch.setattr(run, "driver", lambda kind: SimpleNamespace(run=run_))
    cell = run.load_cell(root, "threeBalls.render")
    cell.entry["chips"] = n
    dev = run.run_cell(cell, 1, 0.1, False, run.cuda_cards(n))["device"]
    assert dev["count"] == n and len({u for _, u in dev["cards"]}) == n
    assert min(dev["memory_peak_bytes_per_card"]) >= 4 << 20
    print(f"# {n} ranks: {dev}")
