"""``fit_intersect_s``: the forward pass's ``diff.intersect`` per step (the
differentiable intersection of each bounce), the mean over the window's
kept ``fit.loss`` records (``_spans``), in s."""

from benchmark.metrics._spans import seconds, window_mean


def read(run):
    return window_mean(run, "fit.loss", lambda r: seconds(r, "diff.intersect"))
