"""``sharded_collective_ms``: per image, ``mesh.allreduce`` (the all-reduces
of the slot sums and the counters, to the counters on the host) on the
rank whose ``mesh.trace`` was longest, so the transfer with no wait for a
slower rank in it; the mean over the window's images (``_ranks``), in
ms."""

from benchmark.metrics._ranks import seconds, traces, window_mean


def _collective(ranks):
    t = traces(ranks)
    return None if t is None else seconds(ranks[t.index(max(t))], "mesh.allreduce")


def read(run):
    s = window_mean(run, _collective)
    return None if s is None else 1e3 * s
