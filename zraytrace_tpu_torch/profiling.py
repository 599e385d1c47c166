"""Wall-clock phase spans, an optional ``torch.profiler`` trace and the
reference's end-of-render report (raytrace.zig:37-50,188-201);
counterpart of ``zraytrace_tpu/profiling.py``."""

from __future__ import annotations

import contextlib
import sys
import time


class PhaseTimer:
    """Named wall-clock spans, like the reference's prepare/render split
    (raytrace.zig:197-200)."""

    def __init__(self):
        self.spans: dict[str, float] = {}

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.spans[name] = self.spans.get(name, 0.0) + time.perf_counter() - t0

    def report(self, file=None):
        file = sys.stderr if file is None else file
        total = sum(self.spans.values())
        for name, s in self.spans.items():
            print(f"  {name:<24} {s:8.2f} s", file=file)
        print(f"  {'total':<24} {total:8.2f} s", file=file)


@contextlib.contextmanager
def torch_trace(log_dir: str | None):
    """A ``torch.profiler`` trace of the block (host operations, and the
    card's kernels where there is one), written to ``log_dir`` as a
    TensorBoard / Chrome ``*.pt.trace.json`` file: the counterpart of the
    JAX package's ``xla_trace``. No-op when ``log_dir`` is None or empty."""
    if not log_dir:
        yield
        return
    import torch
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
