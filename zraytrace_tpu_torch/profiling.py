"""The port's spans and counters, an optional ``torch.profiler`` trace and
the reference's end-of-render report (raytrace.zig:37-50,188-201);
counterpart of ``zraytrace_tpu/profiling.py``.

One store per process holds what the main paths record:

- ``span(name)``, a context manager (or a decorator), times a block on the
  ``time.perf_counter`` clock. The store keeps per name its calls, its
  seconds and its self seconds (its seconds less those of the spans opened
  inside it on the same thread). A span entered while autograd runs a
  backward pass (``torch.utils.checkpoint``'s recompute) is kept apart,
  as recompute, under the same name. While a ``torch.profiler`` session
  is active, a span is also a ``record_function`` range, so it lies in
  the trace on the kernels' timeline; without one it enters none.
- ``count(name, n)`` adds to a counter (kernel launches, cache hits).
- The outermost span on a thread opens a ``Record`` (one image of
  ``render.render``, one loss call ``fit.loss``), which notes when it
  opened and whether a profiler was on; every span and counter until the
  next record opens lands in it, those of autograd's backward thread too.
  The last ``RECORDS_PER_ROOT`` records of each root name are kept, so
  memory stays bounded however long a run is.

Readers: ``totals()``, ``counters()``, ``counter(name)``,
``records(root)``, and ``print_spans()`` for an operator; ``reset()``
empties the store, and ``keep(record)`` adds a record that another process
(a rank) made.
"""

from __future__ import annotations

import collections
import contextlib
import sys
import threading
import time

import torch
import torch.autograd.profiler as _autograd_profiler

# About 1.7 KB a record of an image: a 51 s window of images at 25 ms or
# more each is held whole.
RECORDS_PER_ROOT = 2048


class Stat:
    """Calls, seconds and self seconds of one span name."""

    __slots__ = ("calls", "seconds", "self_seconds")

    def __init__(self):
        self.calls, self.seconds, self.self_seconds = 0, 0.0, 0.0

    def add(self, seconds: float, self_seconds: float) -> None:
        self.calls += 1
        self.seconds += seconds
        self.self_seconds += self_seconds

    def __repr__(self) -> str:
        return f"Stat(calls={self.calls}, seconds={self.seconds}, self={self.self_seconds})"


class Record:
    """One call of a root span and what landed in it: ``spans`` by
    ``(name, recompute)``, ``counters`` by name, ``seconds`` the root's
    own, ``recompute_seconds`` those of the outermost recompute spans;
    ``started`` the ``time.perf_counter`` reading when it opened,
    ``profiled`` whether a ``torch.profiler`` session was active then."""

    __slots__ = ("root", "started", "profiled", "seconds", "spans", "counters",
                 "recompute_seconds")

    def __init__(self, root: str, started: float, profiled: bool):
        self.root, self.started, self.profiled = root, started, profiled
        self.seconds, self.recompute_seconds = 0.0, 0.0
        self.spans: dict[tuple[str, bool], Stat] = {}
        self.counters: dict[str, int] = {}

    def stat(self, name: str, recompute: bool = False) -> Stat | None:
        return self.spans.get((name, recompute))


class Frame:
    """A span while it runs; ``seconds`` is set when it ends."""

    __slots__ = ("recompute", "children", "seconds")

    def __init__(self, recompute: bool):
        self.recompute, self.children, self.seconds = recompute, 0.0, None


_lock = threading.Lock()
_local = threading.local()
_totals: dict[tuple[str, bool], Stat] = {}
_counters: dict[str, int] = {}
_records: dict[str, collections.deque] = {}
_current: Record | None = None


def _add(stats: dict, key, seconds: float, self_seconds: float) -> None:
    stat = stats.get(key)
    if stat is None:
        stat = stats[key] = Stat()
    stat.add(seconds, self_seconds)


@contextlib.contextmanager
def span(name: str):
    """Time the block as span ``name``; yields its ``Frame``."""
    global _current
    stack = _local.__dict__.setdefault("stack", [])
    frame = Frame(torch._C._current_graph_task_id() != -1)
    parent = stack[-1] if stack else None
    profiled = _autograd_profiler._is_profiler_enabled
    opened = None
    if parent is None and not frame.recompute:
        opened = Record(name, time.perf_counter(), profiled)
        with _lock:
            _records.setdefault(name, collections.deque(maxlen=RECORDS_PER_ROOT)).append(opened)
            _current = opened
    ranged = None
    if profiled:
        ranged = torch.profiler.record_function(name)
        ranged.__enter__()
    stack.append(frame)
    t0 = time.perf_counter()
    try:
        yield frame
    finally:
        seconds = time.perf_counter() - t0
        stack.pop()
        if ranged is not None:
            ranged.__exit__(None, None, None)
        frame.seconds = seconds
        if parent is not None:
            parent.children += seconds
        key = (name, frame.recompute)
        with _lock:
            _add(_totals, key, seconds, seconds - frame.children)
            rec = _current
            if rec is not None:
                _add(rec.spans, key, seconds, seconds - frame.children)
                if frame.recompute and not (parent is not None and parent.recompute):
                    rec.recompute_seconds += seconds
            if opened is not None:
                opened.seconds = seconds


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name``."""
    with _lock:
        _counters[name] = _counters.get(name, 0) + n
        if _current is not None:
            _current.counters[name] = _current.counters.get(name, 0) + n


def counter(name: str) -> int:
    return _counters.get(name, 0)


def counters() -> dict[str, int]:
    with _lock:
        return dict(_counters)


def totals() -> dict[tuple[str, bool], Stat]:
    """Every span name's totals since the last ``reset``, by ``(name,
    recompute)``, in the order first seen."""
    with _lock:
        return dict(_totals)


def records(root: str) -> list[Record]:
    """The kept records of root span ``root``, oldest first."""
    with _lock:
        return list(_records.get(root, ()))


def keep(record: Record) -> None:
    """Keep ``record``, made in another process (a rank started by
    ``multihost.run_ranks``, which returns it), among this process's
    records of its root."""
    with _lock:
        _records.setdefault(record.root,
                            collections.deque(maxlen=RECORDS_PER_ROOT)).append(record)


def reset() -> None:
    global _current
    with _lock:
        _totals.clear()
        _counters.clear()
        _records.clear()
        _current = None


def print_spans(file=None) -> None:
    """The store's span totals and counters, one line each, to ``file``
    (the standard error stream at the time of the call by default)."""
    file = sys.stderr if file is None else file
    print(f"  {'span':<28} {'calls':>7} {'seconds':>10} {'self':>10}", file=file)
    for (name, recompute), st in totals().items():
        label = f"{name} (recompute)" if recompute else name
        print(f"  {label:<28} {st.calls:>7} {st.seconds:>10.4f} {st.self_seconds:>10.4f}",
              file=file)
    for name, n in counters().items():
        print(f"  {name:<28} {n:>7}", file=file)


@contextlib.contextmanager
def torch_trace(log_dir: str | None):
    """A ``torch.profiler`` trace of the block (host operations, the spans
    as ranges, and the card's kernels where there is one), written to
    ``log_dir`` as a TensorBoard / Chrome ``*.pt.trace.json`` file: the
    counterpart of the JAX package's ``xla_trace``. No-op when ``log_dir``
    is None or empty."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


def print_render_report(stats, file=None):
    """The reference's end-of-render block (raytrace.zig:188-201), to
    ``file`` (the standard error stream at the time of the call by
    default)."""
    file = sys.stderr if file is None else file
    print("Rendering ready", file=file)
    print(f"  Total reflections:     {stats.reflections}", file=file)
    print(f"  Total background hits: {stats.background_hits}", file=file)
    print(f"  Total pixels:          {stats.pixels}", file=file)
    print(f"  Total samples:         {stats.samples}", file=file)
    print(f"  Total rays:            {stats.rays}", file=file)
    print(f"  Recursion limit hits:  {stats.recursion_depth_hits}", file=file)
    print(f"  Wavefront iterations:  {stats.wavefront_iterations}", file=file)
    print(f"  Pixels per second:     {stats.pixels_per_second:.2f}", file=file)
    print(f"  Rays per second:       {stats.rays_per_second:.3e}", file=file)
    print(f"  Total runtime:         {stats.preprocess_seconds + stats.render_seconds:.2f} s",
          file=file)
    print(f"    Prepare runtime:     {stats.preprocess_seconds:.2f} s", file=file)
    print(f"    Render runtime:      {stats.render_seconds:.2f} s", file=file)
