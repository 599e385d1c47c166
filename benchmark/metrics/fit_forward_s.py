"""``fit_forward_s``: the mean seconds of a window step's loss call
(``render_diff`` and its kernels), ending in a synchronise."""


def read(run):
    return run.get("forward_s")
