"""``sharded_host_ms``: per image, rank 0's host work in
``render_sharded``: ``mesh.prepare`` (scene and camera to the card,
routing, lane ids), ``mesh.fetch`` (the image's sums to the host) and
``mesh.divide``; the mean over the window's images (``_ranks``), in ms."""

from benchmark.metrics._ranks import seconds, window_mean


def read(run):
    s = window_mean(run, lambda ranks: seconds(ranks[0], "mesh.prepare", "mesh.fetch",
                                               "mesh.divide"))
    return None if s is None else 1e3 * s
