"""``bounce_roofline``: the bounce kernel's share of its roofline in
the traced images, the least time of their frozen work (``roofline``)
over the kernel's device time, found by name in the profiler's trace;
nothing where the trace shows no such kernel."""

from benchmark import roofline


def read(run):
    prof, images = run.get("profile"), run.get("profiled_images")
    work = run["cell"].config["work"]
    kernel_s = sum(s for name, s in prof["kernels"].items() if work["kernel"] in name)
    if not images or kernel_s <= 0:
        return None
    least = sum(roofline.least_seconds(roofline.image_ops(work, im),
                                       roofline.image_bytes(work, run["width"], run["height"]))
                for im in images)
    return 100.0 * least / kernel_s
