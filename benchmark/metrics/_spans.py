"""Readings of the program's span store (``zraytrace_tpu_torch.profiling``)
after a traced run on the card.

A window reading is the mean, over the kept records of a root span that
the window made, of a number read from each record: records opened after
set-up ended (``run["setup_end"]``) and with no profiler on, so the
warm-up image, the fit's start step and the profiler pass's calls do not
move it, and the calls averaged are those of the window's host-clock
metrics (``render_host_ms``, ``fit_forward_s``). A set-up reading sums
the records opened before set-up ended.

Nothing where the run was not on a CUDA device (the host's plain paths
run inside the same spans, so their times mean something else), where
the program keeps no such store, or where no record holds the span."""

from __future__ import annotations

import statistics

import torch


def _records(run, root: str):
    cell = run.get("cell")
    if cell is None or torch.device(cell.device).type != "cuda":
        return None
    try:
        from zraytrace_tpu_torch import profiling
    except ImportError:
        return None
    records = getattr(profiling, "records", None)
    return None if records is None else records(root)


def window_mean(run, root: str, value):
    """The mean of ``value(record)`` over ``root``'s records of the window,
    those where it is None left out; None where none is left."""
    recs = _records(run, root)
    if recs is None:
        return None
    values = [value(r) for r in recs if r.started >= run["setup_end"] and not r.profiled]
    values = [v for v in values if v is not None]
    return statistics.fmean(values) if values else None


def setup_total(run, root: str, value):
    """The sum of ``value(record)`` over ``root``'s records opened in
    set-up; None where there is none."""
    recs = _records(run, root)
    if recs is None:
        return None
    values = [value(r) for r in recs if r.started < run["setup_end"]]
    values = [v for v in values if v is not None]
    return sum(values) if values else None


def seconds(record, *names: str):
    """The seconds of the forward spans ``names`` in ``record``, summed over
    those present; None where none is."""
    stats = [record.stat(n) for n in names]
    if all(s is None for s in stats):
        return None
    return sum(s.seconds for s in stats if s is not None)
