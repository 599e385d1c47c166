"""Fixtures of the benchmark's tests: a copy of the benchmark's data at
cut sizes, run on the host."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]

# cut sizes: the host runs the program's plain paths
TINY = {
    "render": dict(width=8, height=8, spp=2, depth=4),
    "albedo_fit": dict(size=8, spp=1, depth=3),
    "pose_fit": dict(size=8, spp=1, depth=2),
}


def tiny_root(dst: Path) -> Path:
    """A benchmark root in ``dst``: ``BENCHMARK.json`` and the data files
    copied, every configuration's render and every traffic mix cut to
    ``TINY``, the assets linked."""
    shutil.copy(REPO / "BENCHMARK.json", dst / "BENCHMARK.json")
    for sub in ("configs", "traffic", "metrics", "limits"):
        shutil.copytree(REPO / "benchmark" / sub, dst / "benchmark" / sub)
    (dst / "assets").symlink_to(REPO / "assets")
    for p in (dst / "benchmark" / "configs").glob("*.json"):
        cfg = json.loads(p.read_text())
        cfg["render"].update(TINY["render"])
        p.write_text(json.dumps(cfg))
    for p in (dst / "benchmark" / "traffic").glob("*.json"):
        tr = json.loads(p.read_text())
        tr.update(TINY.get(p.stem, {}))
        if tr["kind"] == "render":
            tr.update(check=dict(pixels=64, images=2, event_samples=TINY["render"]["spp"]),
                      profile_images=2)
        p.write_text(json.dumps(tr))
    return dst


@pytest.fixture
def root(tmp_path):
    return tiny_root(tmp_path)
