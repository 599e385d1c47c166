"""``fit_shade_s``: the forward pass's ``diff.bounce`` self time per step
(the bounce's shading and path updates: its time outside
``diff.intersect`` and ``diff.edge``), the mean over the window's kept
``fit.loss`` records (``_spans``), in s."""

from benchmark.metrics._spans import window_mean


def _shade(record):
    stat = record.stat("diff.bounce")
    return None if stat is None else stat.self_seconds


def read(run):
    return window_mean(run, "fit.loss", _shade)
