"""The port's report tools (``zraytrace_tpu_torch/tools/``) and the CLI's
``--no-bvh`` and ``ZRAYTRACE_TRACE_DIR``, on the CPU at cut sizes.

``weak_scaling`` starts gloo ranks (fresh processes) that render on the
host; its rows' event counters equal ``render()``'s at the same
parameters. ``mesh_parity_probe``'s engines are the same plain version on
the host, so its envelope arithmetic is held on canned results.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from zraytrace_tpu_torch import RenderParams
from zraytrace_tpu_torch.cli import main as cli_main
from zraytrace_tpu_torch.io.png import read_png
from sharded_reference import reference_sums
from zraytrace_tpu_torch.render import render
from zraytrace_tpu_torch.scenes import build_scene
from zraytrace_tpu_torch.tools import (
    diff_decomp,
    mesh_parity_probe,
    occl_grad_probe,
    render_showcase,
    weak_scaling,
)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
EVENTS = ("rays", "reflections", "background_hits", "recursion_depth_hits", "samples")


def test_weak_scaling_on_gloo_ranks(tmp_path):
    out = tmp_path / "ws.json"
    assert weak_scaling.main(["--cpu", "--counts", "1", "2", "--width", "16", "--base", "8",
                              "--spp", "2", "--out", str(out)]) == 0
    rep = json.loads(out.read_text())
    ref = json.loads((ROOT / "WEAK_SCALING.json").read_text())
    assert set(ref) <= set(rep) and set(rep["axes"]) == set(ref["axes"])
    assert "not scaling across cards" in rep["caveat"] and rep["device"] == "cpu"
    built = build_scene(1, "cpu")
    for axis, rows in rep["axes"].items():
        assert [r["n_devices"] for r in rows] == [1, 2]
        for row in rows:
            assert set(ref["axes"][axis][0]) <= set(row), axis
            assert row["backend"] == "gloo" and row["wall_seconds"] > 0
            p = row["params"]
            params = RenderParams(p["width"], p["height"], p["spp"], p["depth"])
            _, st = render(built.scene, built.camera, params, "cpu")
            assert row["counters"][:5] == [getattr(st, k) for k in EVENTS], (axis, row)
            if axis == "data":  # the longest lane over one sample block is the longest rank's
                _, want = reference_sums(built.scene, built.camera, params, row["n_devices"])
                assert row["counters"][5] == want[5]
        assert rows[0]["weak_scaling_efficiency"] == 1.0
    with pytest.raises(SystemExit):
        weak_scaling.main(["--cpu", "--out", str(tmp_path / "WEAK_SCALING.json")])


def test_weak_scaling_rank_counts():
    assert weak_scaling.rank_counts(4) == [1, 2, 4]
    assert weak_scaling.rank_counts(8) == [1, 2, 4, 8]


def test_render_showcase(tmp_path):
    assert render_showcase.main([str(tmp_path), "--scene", "1", "--scene", "3", "--size",
                                 "16", "--spp", "2", "--depth", "4", "--cpu"]) == 0
    rows = (tmp_path / "SWEEP.md").read_text().splitlines()
    assert len(rows) == 2 and rows[0].startswith("| 1 threeBalls | 16x16 | 2 | 4 |")
    assert rows[1].startswith("| 3 teapotAndBall | 16x16 | 2 | 4 |") and "| cpu |" in rows[1]
    img = read_png(tmp_path / "threeBalls_16x16_2spp.png")
    assert img.shape == (16, 16, 3)
    _, st = render(*build_scene(1, "cpu")[:2], RenderParams(16, 16, 2, 4), "cpu")
    cells = [c.strip() for c in rows[0].strip("|").split("|")]
    assert [int(c) for c in cells[4:8]] == [getattr(st, k) for k in EVENTS[:4]]


def test_render_showcase_refuses_the_reference_record():
    before = (ROOT / "showcase" / "SWEEP.md").read_text()
    for outdir in (ROOT / "showcase", str(ROOT / "showcase") + "/"):
        with pytest.raises(ValueError, match="JAX package's showcase"):
            render_showcase.render_scene(1, outdir, spp=1, size=4, depth=1, device="cpu")
    assert (ROOT / "showcase" / "SWEEP.md").read_text() == before


def _canned(kernel_counts, wave_counts, kernel_img, wave_img, kernel_again=None):
    k2 = kernel_counts if kernel_again is None else kernel_again
    return {"kernel": [(kernel_img, kernel_counts), (kernel_img.copy(), k2)],
            "wavefront": [(wave_img, wave_counts), (wave_img.copy(), wave_counts)]}


def test_mesh_parity_envelope():
    img = np.zeros((10, 10, 3), np.float32)
    near = img.copy()
    near[0, 0, 1] = 0.01  # 1 pixel of 100 off by more than 1e-3
    c = (1_000_000, 400_000, 600_000, 3)
    r = mesh_parity_probe.envelope(_canned(c, (1_000_040, 400_040, 600_000, 3), img, near))
    assert r["ok"] and r["rel_events"] == 40 / 1_000_040 and r["pixels_over"] == 1
    assert r["pixel_frac"] == pytest.approx(0.01)
    # one bar at a time: events, pixels, determinism
    assert not mesh_parity_probe.envelope(
        _canned(c, (1_000_060, 400_000, 600_000, 3), img, img))["ok"]
    far = img.copy()
    far[0, :2, 0] = 0.5  # 2% of the pixels
    r = mesh_parity_probe.envelope(_canned(c, c, img, far))
    assert not r["ok"] and r["pixel_frac"] == pytest.approx(0.02)
    r = mesh_parity_probe.envelope(_canned(c, c, img, img, kernel_again=(1_000_001,) + c[1:]))
    assert not r["ok"] and r["deterministic"] == {"kernel": False, "wavefront": True}
    assert mesh_parity_probe.envelope(_canned(c, c, img, img))["ok"]


def test_mesh_parity_probe_on_the_host():
    """With ``--cpu`` both engines run the plain version: equal."""
    assert mesh_parity_probe.main(["--cpu", "--check", "--scene", "3", "--size", "12",
                                   "--spp", "1", "--depth", "3"]) == 0


def test_occl_grad_probe():
    rows = occl_grad_probe.probe((1.0,), size=8, spp=1, depth=2, device="cpu", verbose=False)
    (row,) = rows
    assert row["scale"] == 1.0 and len(row["fd"]) == 3 and np.isfinite(row["fd"]).all()
    assert set(row["modes"]) == {"off", "camera", "all"}
    for m in row["modes"].values():
        assert np.isfinite(m["grad"]).all() and -1.0 <= m["cos"] <= 1.0 and m["ratio"] >= 0


@pytest.mark.parametrize("teapot", [False, True])
def test_diff_decomp(teapot, capsys):
    argv = ["--cpu", "--steps", "1", "--size", "8", "--spp", "1", "--depth", "2"]
    assert diff_decomp.main(argv + (["--teapot"] if teapot else [])) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    names = diff_decomp.TEAPOT_VARIANTS if teapot else diff_decomp.SPHERE_VARIANTS
    assert list(out["diff_decomp"]) == list(names) and out["device"] == "cpu"
    assert all(v["step_seconds"] > 0 for v in out["diff_decomp"].values())


def test_cli_no_bvh_changes_nothing(tmp_path, capsys):
    imgs = []
    for flag in ([], ["--no-bvh"]):
        path = tmp_path / f"o{len(flag)}.png"
        assert cli_main(["16", "12", "2", "4", "3", str(path), "--cpu"] + flag) == 0
        imgs.append(read_png(path))
    np.testing.assert_array_equal(imgs[0], imgs[1])
    err = capsys.readouterr().err
    reports = [blk for blk in err.split("Rendering ready")[1:]]
    assert len(reports) == 2
    assert reports[0].split("Wavefront")[0] == reports[1].split("Wavefront")[0]


def test_cli_trace_dir(tmp_path, monkeypatch):
    trace = tmp_path / "trace"
    monkeypatch.setenv("ZRAYTRACE_TRACE_DIR", str(trace))
    assert cli_main(["8", "6", "1", "2", "1", str(tmp_path / "o.png"), "--cpu"]) == 0
    files = list(trace.glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("render" in e.get("name", "") or e.get("name", "").startswith("aten::")
               for e in events)
