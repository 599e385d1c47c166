"""``fit_edge_s``: the forward pass's ``diff.edge`` per step (the edge
factor of each bounce), the mean over the window's kept ``fit.loss``
records (``_spans``), in s."""

from benchmark.metrics._spans import seconds, window_mean


def read(run):
    return window_mean(run, "fit.loss", lambda r: seconds(r, "diff.edge"))
