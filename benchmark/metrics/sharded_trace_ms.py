"""``sharded_trace_ms``: the slowest rank's bounce kernel, its device time
an image of the traced pass, found by name in each rank's profiler trace
(``_ranks.kernel_seconds``); the image waits for it, in ms."""

from benchmark.metrics._ranks import kernel_seconds


def read(run):
    per = kernel_seconds(run)
    return None if per is None else 1e3 * max(per)
