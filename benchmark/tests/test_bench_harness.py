"""The harness on the host at cut sizes: every cell runs and checks, data
files are found by name, the window's arithmetic, the import guard, and
the exits without a card."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

import pytest

from benchmark import roofline, run
from benchmark.drivers import closed_loop
from benchmark.drivers.render import window_metrics
from benchmark.tests.conftest import REPO

CELLS = ["threeBalls.render", "teapot.render", "threeBalls.albedo_fit", "teapot.pose_fit"]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_and_checks_on_the_host(cell, root):
    out = run.run_cell(run.load_cell(root, cell), 4_000_000_007, 0.2, False, "cpu")
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    want = {m["name"] for m in bench["end_to_end"] if cell in m.get("workloads", [cell])}
    assert set(out["metrics"]) == want
    assert list(out)[-1] == "checks"


def test_traced_run_reads_its_per_layer_metrics(root):
    out = run.run_cell(run.load_cell(root, "threeBalls.render"), 5, 0.2, True, "cpu")
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
    out = run.run_cell(run.load_cell(root, "smallBalls.render_once"), 9, 0.2, True, "cpu")
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
    run.run_cell(run.load_cell(pathlib.Path({str(root)!r}), cell), 11, 0.1, cell.endswith('render'), 'cpu')
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
