"""``sharded_balance_pct``: the ranks' mean bounce-kernel device time over
the slowest rank's, in the traced pass (``_ranks.kernel_seconds``), in %
(100: every rank's kernel runs as long; the split of lanes over ranks
sets it)."""

import statistics

from benchmark.metrics._ranks import kernel_seconds


def read(run):
    per = kernel_seconds(run)
    return None if per is None else 100.0 * statistics.fmean(per) / max(per)
