"""The JAX package's recorded renders in ``showcase/``, and the bars a
render of the port is held to against them.

``showcase/SWEEP.md`` holds one row per render (scene, size, spp, depth
and the four event counters); ``showcase/<name>_<W>x<H>_<spp>spp.png`` the
image of some. The first row of a configuration is the current engines'
(the round-3 table). The port traces the same PCG4D streams, so its
counters land within a rounding of the record's, and its image within a
fraction of an 8-bit level; a wrong material, normal or texture would be
tens of levels off.

- counters: each event count per sample within ``EVENT_TOL`` of the
  record's at the same configuration (the engines round differently and
  long paths amplify one-ulp differences: the two TPU engines' own scene-4
  rows differ by 5e-5 per sample);
- image: the mean 8-bit difference from the record's PNG below
  ``PNG_BAR``.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import NamedTuple

import numpy as np

from zraytrace_tpu_torch.io.png import decode_png, quantize

__all__ = ["DIRECTORY", "EVENT_TOL", "PNG_BAR", "Record", "record", "png", "events_off",
           "mean_8bit_diff"]

DIRECTORY = Path(__file__).resolve().parents[1] / "showcase"
EVENT_TOL = 1e-4
PNG_BAR = 0.5


class Record(NamedTuple):
    """One ``SWEEP.md`` row: rays, reflections, background and
    recursion-depth hits, and the samples they were counted over."""

    counts: tuple
    samples: int


def record(name: str, width: int, height: int, spp: int, depth: int) -> Record:
    """The first ``SWEEP.md`` row of scene ``name`` at this configuration;
    ``LookupError`` if there is none."""
    size = f"{width}x{height}"
    pattern = re.compile(rf"\|\s*\d+ {re.escape(name)} \| {size} \| {spp} \| {depth} \|")
    for line in (DIRECTORY / "SWEEP.md").read_text().splitlines():
        if pattern.match(line):
            cells = [c.strip() for c in line.strip().strip("|").split("|")]
            return Record(tuple(int(c) for c in cells[4:8]), width * height * spp)
    raise LookupError(f"showcase/SWEEP.md has no {name} {size} {spp} spp d{depth} row")


def png(name: str, width: int, height: int, spp: int) -> np.ndarray:
    """The record's image, ``(H, W, 3)`` uint8, row 0 the top."""
    return decode_png((DIRECTORY / f"{name}_{width}x{height}_{spp}spp.png").read_bytes())


def events_off(counts, samples: int, rec: Record) -> float:
    """The largest difference of an event count per sample (rays,
    reflections, background, recursion-depth hits) from the record's."""
    return max(abs(x / samples - y / rec.samples) for x, y in zip(counts, rec.counts))


def mean_8bit_diff(image, reference: np.ndarray) -> float:
    """Mean absolute difference, in 8-bit levels, of a float image (row 0
    the bottom, as ``render()`` returns it) from a PNG's pixels."""
    ours = quantize(np.asarray(image))[::-1].astype(np.float64)
    return float(np.abs(ours - reference[..., :3].astype(np.float64)).mean())
