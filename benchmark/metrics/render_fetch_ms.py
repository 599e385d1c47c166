"""``render_fetch_ms``: ``render.fetch`` per image (the slot sums' copy to
the host), the mean over the window's kept ``render.render`` records
(``_spans``), in ms."""

from benchmark.metrics._spans import seconds, window_mean


def read(run):
    s = window_mean(run, "render.render", lambda r: seconds(r, "render.fetch"))
    return None if s is None else 1e3 * s
