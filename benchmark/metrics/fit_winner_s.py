"""``fit_winner_s``: the forward pass's ``diff.winner`` and
``diff.margins`` per step (the no-grad winner pass, with the flash
kernel, and the margin selection, with the margin kernel), the mean over
the window's kept ``fit.loss`` records (``_spans``), in s."""

from benchmark.metrics._spans import seconds, window_mean


def read(run):
    return window_mean(run, "fit.loss", lambda r: seconds(r, "diff.winner", "diff.margins"))
