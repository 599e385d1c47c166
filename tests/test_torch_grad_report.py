"""The port's gradient-quality report against the JAX package's, on the
CPU (``zraytrace_tpu_torch/tools/grad_report.py`` against
``tools/grad_report.py``).

The port's report at tests/test_grad_report.py's reduced config meets
that test's bars; its first seed's gradient and FD values per class equal
the JAX report's at the same config within the gradient bar of
tests/test_diff_mesh.py (``atol = 5e-4 max|g|``, ``rtol = 2e-3``), as do
the camera-pose class's (``look_from`` through ``make_camera``).
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from tools.grad_report import compute_report as jax_compute_report  # noqa: E402
from zraytrace_tpu_torch.tools import grad_report  # noqa: E402

torch.set_num_threads(1)

GRAD_ATOL, GRAD_RTOL = 5e-4, 2e-3  # tests/test_diff_mesh.py:104-106
REDUCED = dict(width=32, height=32, spp=32, classes=("sphere_radius", "albedo"))


def _assert_values_match(got: dict, want: dict):
    for name, w in want["classes"].items():
        g = got["classes"][name]
        for key in ("grad", "fd"):
            ref = np.asarray(w[key])
            scale = np.abs(ref).max()
            np.testing.assert_allclose(g[key], ref, atol=GRAD_ATOL * scale, rtol=GRAD_RTOL,
                                       err_msg=f"{name} {key}")


@pytest.fixture(scope="module")
def reduced():
    return grad_report.compute_report(verbose=False, device="cpu", **REDUCED)


def test_reduced_config_meets_the_reference_bars(reduced):
    """tests/test_grad_report.py::test_grad_report_reduced_config's bars,
    five seeds."""
    cls = reduced["classes"]
    assert reduced["config"]["seeds"] == [42, 143, 244, 345, 446]
    assert cls["albedo"]["max_rel_error"] < 0.02
    assert cls["sphere_radius"]["max_rel_error"] < 0.35
    assert reduced["max_rel_error_overall"] == max(c["max_rel_error"] for c in cls.values())


def test_first_seed_matches_jax(reduced):
    """The first seed's per-class gradient and FD values against the JAX
    report's with one seed at the same config."""
    want = jax_compute_report(verbose=False, n_seeds=1, **REDUCED)
    _assert_values_match(reduced, want)


def test_camera_pose_matches_jax():
    cfg = dict(width=16, height=16, spp=8, classes=("camera_pose",), n_seeds=1,
               verbose=False)
    got = grad_report.compute_report(device="cpu", **cfg)
    want = jax_compute_report(**cfg)
    _assert_values_match(got, want)
    g = got["classes"]["camera_pose"]
    assert len(g["grad"]) == 2 and min(abs(x) for x in g["fd"]) > 0


def test_main_writes_the_ports_report(tmp_path):
    """``main`` writes its own file with the device beside the numbers,
    and refuses to overwrite the reference's ``GRAD_REPORT.json``."""
    out = tmp_path / "r.json"
    assert grad_report.main(["--cpu", "--size", "8", "--spp", "2", "--seeds", "1",
                             "--classes", "albedo", "--out", str(out)]) == 0
    rep = json.loads(out.read_text())
    assert rep["device"] == "cpu" and rep["power_limit"] is None and rep["n_seeds"] == 1
    assert set(rep["classes"]) == {"albedo"} and rep["wall_seconds"] > 0
    with pytest.raises(SystemExit):
        grad_report.main(["--cpu", "--out", "GRAD_REPORT.json"])


def test_class_errors_floor():
    """A component at a tenth of the class's largest |FD| is held to a
    fifth of it, as in the reference's ``entry``."""
    assert grad_report.class_errors([1.1, 0.1], [1.0, 0.0]) == pytest.approx(0.5)
    assert grad_report.class_errors([0.9], [1.0]) == pytest.approx(0.1)


def test_artifact_meets_the_reference_bars():
    """``GRAD_REPORT_TORCH.json``, the port's full report from the card,
    meets tests/test_grad_report.py's artifact bars and names its device."""
    path = Path(__file__).resolve().parent.parent / "GRAD_REPORT_TORCH.json"
    rep = json.loads(path.read_text())
    assert rep["device"] != "cpu" and rep["power_limit"]
    assert rep["config"]["width"] == rep["config"]["height"] == 64
    assert rep["config"]["spp"] == 128 and len(rep["config"]["seeds"]) == rep["n_seeds"]
    assert rep["max_rel_error_overall"] < 0.45
    for k in ("sphere_center", "camera_pose", "triangle_vertex"):
        assert rep["classes"][k]["max_rel_error"] < 0.45, k
    assert rep["classes"]["albedo"]["max_rel_error"] < 0.02
    assert rep["classes"]["ior"]["max_rel_error"] < 0.05
    assert rep["classes"]["sphere_radius"]["max_rel_error"] < 0.10
