"""``fit_backward_s``: the mean seconds of a window step from its loss to
after Adam's update (autograd's backward pass with its checkpointed
recompute, then the update), ending in a synchronise."""


def read(run):
    return run.get("backward_s")
