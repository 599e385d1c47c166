"""The general generators: one per traffic ``kind``, each reading a
traffic file's parameters and a configuration's sizes.

``run(cell)`` builds the program's side (set-up), drives the measured
window, and, in a traced run, the profiler pass after it. It returns a
dict with the window's records, the end-to-end metrics, what the
per-layer readers read, and ``check``: a function that frees the
program's state and compares the window's outputs with the reference.
"""

from __future__ import annotations

import time

import torch


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def closed_loop(fn, seconds: float, device) -> tuple:
    """Call ``fn(i)`` for i = 0, 1, ... until ``seconds`` have passed
    since the first call began, the last call finished: ``(results,
    window seconds)``. The window ends when the device has finished the
    last call's work, so it holds all the work of every call in it."""
    out = []
    sync(device)
    t0 = time.perf_counter()
    while True:
        out.append(fn(len(out)))
        if time.perf_counter() - t0 >= seconds:
            sync(device)
            return out, time.perf_counter() - t0
