"""``render_divide_ms``: ``render.divide`` per image (the host's divide of
the sums by the samples, and the reshape), the mean over the window's
kept ``render.render`` records (``_spans``), in ms."""

from benchmark.metrics._spans import seconds, window_mean


def read(run):
    s = window_mean(run, "render.render", lambda r: seconds(r, "render.divide"))
    return None if s is None else 1e3 * s
