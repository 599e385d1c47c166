"""Readings of what ``drivers/render_sharded.py``'s ranks return: their
``mesh.render`` records, as ``run["ranks"]`` (per rank, its set-up's end
and its records as numbers: spans' seconds by name, counters), and with
``--trace 1`` their profiler passes, as ``run["rank_profiles"]``.

A reading is the mean, over the window's images, of a number read from
one image's records on every rank: records opened after the rank's
set-up ended and with no profiler on, so the warm-up image and the
profiler pass's images do not move it. Every rank renders every image,
so the ranks' kept records line up, the last with the last.

Nothing where the run was not on a CUDA device, where it returned no
ranks' records, or where no image's records hold the spans read."""

from __future__ import annotations

import statistics

import torch


def images(run):
    """Per window image, its records on each rank, rank 0 first; None
    where there are none."""
    cell, ranks = run.get("cell"), run.get("ranks")
    if cell is None or torch.device(cell.device).type != "cuda" or not ranks:
        return None
    kept = [[r for r in recs if r["started"] >= setup_end and not r["profiled"]]
            for setup_end, recs in ranks]
    n = min(len(k) for k in kept)
    return [[k[len(k) - n + i] for k in kept] for i in range(n)] or None


def window_mean(run, value):
    """The mean of ``value(one image's records)`` over the window's
    images, those where it is None left out; None where none is left."""
    per_image = images(run)
    if per_image is None:
        return None
    values = [v for v in map(value, per_image) if v is not None]
    return statistics.fmean(values) if values else None


def seconds(record, *names: str):
    """The seconds of the spans ``names`` in ``record``, summed; None
    where one is missing."""
    spans = [record["spans"].get(n) for n in names]
    return None if None in spans else sum(spans)


def traces(ranks: list):
    """Each rank's ``mesh.trace`` seconds for one image; None where a rank
    has none."""
    t = [seconds(r, "mesh.trace") for r in ranks]
    return None if None in t else t


def kernel_seconds(run):
    """Per rank, the device seconds of the cell's kernel (``work``'s
    ``kernel``, by name) an image of its traced pass (``rank_profiles``);
    None off CUDA, without the ranks' profiles, or where a rank's trace
    shows no such kernel."""
    cell, profiles, images = run.get("cell"), run.get("rank_profiles"), run.get("profiled_images")
    if cell is None or torch.device(cell.device).type != "cuda" or not profiles or not images:
        return None
    name = cell.config["work"]["kernel"]
    per = [sum(s for k, s in p["kernels"].items() if name in k) / len(images) if p else 0.0
           for p in profiles]
    return None if min(per) <= 0 else per
