"""``fit_recompute_s``: the backward pass's recompute per step (the
outermost spans entered while autograd ran the backward pass: each
bounce's checkpointed part again), the mean over the window's kept
``fit.loss`` records (``_spans``), in s."""

from benchmark.metrics._spans import window_mean


def _recompute(record):
    if not any(recompute for _, recompute in record.spans):
        return None
    return record.recompute_seconds


def read(run):
    return window_mean(run, "fit.loss", _recompute)
