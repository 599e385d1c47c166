"""The general generators: one per traffic ``kind``, each reading a
traffic file's parameters and a configuration's sizes.

``run(cell)`` builds the program's side (set-up), drives the measured
window, and, in a traced run, the profiler pass after it. It returns a
dict with the window's records, the end-to-end metrics, what the
per-layer readers read, and ``check``: a function that frees the
program's state and compares the window's outputs with the reference.

A driver reads its cards from ``cell.devices``, the ``chips`` CUDA
devices the cell asks for, ``cuda:0`` up (``cell.device`` is the first;
a one-card driver reads that alone). The harness counts the cards the
run used from one record per card (``benchmark.cards.record``: the CUDA
index, the UUID, the name, the peak bytes allocated, and in a traced run
the card's ``busy_s`` and ``window_s``), a card with peak bytes above 0
counting as used:

- A driver that does its work in the harness's process returns no
  ``devices``: the harness takes the record of each handed card itself,
  with the busy seconds of the ``profile`` the driver returns.
- A driver that does its work in processes of its own (one rank a card)
  returns ``devices``: its ranks' records, each taken by
  ``benchmark.cards.record`` inside the rank after its last call of the
  window (and, in a traced run, with the rank's own ``profile``), and
  passed back to the harness's process.

A run that used fewer distinct cards than ``chips``, a card twice, or
cards of different kinds exits 5 with no result (``run.py``).
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
