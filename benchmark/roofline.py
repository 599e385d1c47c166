"""The yardstick of the kernel metrics: the card's peaks and the frozen
work of an image.

Peaks: one H100 SXM, NVIDIA's data sheet, dense FP32 outside the tensor
cores and HBM3. The work of an image is priced from its own event
counters with the per-event prices of its configuration
(``configs/<config>.json``, ``work``), which were read once from the
program's counting build at the cell's shapes and then frozen, so that a
later kernel or BVH does not move the yardstick.
"""

from __future__ import annotations

PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def image_ops(work: dict, counters: dict) -> float:
    """Operations of one image: each event counter times its price."""
    return sum(price * counters[event] for event, price in work["ops_per_event"].items())


def image_bytes(work: dict, width: int, height: int) -> float:
    """Bytes of one image: the scene's tables read once and the image's
    float32 sums written once."""
    return work["table_bytes"] + 12.0 * width * height


def least_seconds(ops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the operations
    over the FP32 peak and the bytes over the memory peak."""
    return max(ops / PEAK_FLOPS, nbytes / PEAK_BYTES)
