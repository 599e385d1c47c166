"""The probes' shared harness: device choice, variant selection, the
card line, CUDA-event timing, the kernel/plain comparison, and the
builds and alternating timing of a measurement beside another checkout
(``mesh_ab``, ``flash_ab``).

Each probe module (``rng_probe``, ``inkernel_texel_probe``,
``body_probe``, ``flash3_probe``, ``pallas_probe``, ``gather_probe3``,
``overlap_probe``, ``flash2_probe``) is a micro-benchmark with a
hand-written CUDA kernel (``csrc/probe_*.cu``) and a plain PyTorch
version of the same function. Its ``measure(device, variants)`` returns
one row per variant; on the card it holds the kernel against the plain
version and raises ``ProbeMismatch`` where they disagree, so a variant
that fails to build, launch or agree ends the process with an error. With
``--cpu`` only the plain versions run, timed on the host clock.

A row (``dict``): ``probe``, ``variant``, ``ms`` (the kernel's time for
one launch of the TPU tool's shape, CUDA events), ``plain_ms`` (the plain
version's time for the same work), ``per`` and ``unit`` (the kernel's
time per lane, element, texel or triangle pair, as the tool printed it),
``max_abs_err`` (kernel against plain) and ``device``; optionally
``library_ms`` (one PyTorch library call for the same work, timed only)
and ``note``. On the host ``ms`` is None and ``plain_ms`` is host time. A
row with neither time is a check that times nothing (its ``note`` says
what was checked); a row with ``ms`` alone is a library call's.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import subprocess
import time
from pathlib import Path

import torch

__all__ = ["ProbeMismatch", "THIS", "device_from_argv", "select", "card_line", "time_ms",
           "time_graph", "time_graph_calls", "build_checkouts", "ab_rounds", "bind", "launch",
           "compare", "format_row", "main_for", "as_int32_bits"]

THIS = "this"  # the name of this checkout's build beside others


class ProbeMismatch(RuntimeError):
    """A probe kernel disagreed with its plain version."""


def device_from_argv(argv) -> tuple[torch.device, list[str]]:
    """(device, variant names) from a probe's arguments: ``--cpu`` runs
    the plain versions on the host; otherwise the card is required."""
    names = [a for a in argv if not a.startswith("-")]
    unknown = [a for a in argv if a.startswith("-") and a != "--cpu"]
    if unknown:
        raise ValueError(f"unknown options {unknown}; the only option is --cpu")
    if "--cpu" in argv:
        return torch.device("cpu"), names
    if not torch.cuda.is_available():
        raise RuntimeError("the probes run on a CUDA device; pass --cpu to run the plain "
                           "versions on the host")
    return torch.device("cuda", 0), names


def select(names, variants) -> list[str]:
    """The variants named (all when none is), in the given order."""
    unknown = [n for n in names if n not in variants]
    if unknown:
        raise ValueError(f"unknown variants {unknown}; choose from {list(variants)}")
    return list(names) or list(variants)


def card_line() -> str:
    """``name, power limit`` of card 0, as nvidia-smi reports them."""
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if proc.returncode != 0 or not proc.stdout.strip():
        raise RuntimeError(f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


def time_ms(fn, device: torch.device, repeats: int = 5):
    """(result, milliseconds per call) after one warm-up call: CUDA events
    around ``repeats`` calls on the card, the host clock on the CPU."""
    result = fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(repeats):
            result = fn()
        end.record()
        torch.cuda.synchronize(device)
        return result, start.elapsed_time(end) / repeats
    t0 = time.perf_counter()
    for _ in range(repeats):
        result = fn()
    return result, (time.perf_counter() - t0) * 1e3 / repeats


def time_graph(fn, device: torch.device, launches: int = 20) -> float:
    """Milliseconds per call of ``fn``, a few microseconds of device work,
    timed as one CUDA graph of ``launches`` calls (so the host's launch
    overhead does not sit between them); the host clock on the CPU."""
    if device.type != "cuda":
        return time_ms(fn, device)[1]
    fn()  # build and warm up outside the capture
    torch.cuda.synchronize(device)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / launches


def time_graph_calls(fns, device: torch.device, replays: int = 20) -> float:
    """Milliseconds per call of the functions ``fns``, each launching a few
    kernels: one CUDA graph of all of them, captured after a warm-up run,
    replayed ``replays`` times between CUDA events (device time, with no
    host work between the launches)."""
    for fn in fns:
        fn()
    torch.cuda.synchronize(device)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for fn in fns:
            fn()
    graph.replay()
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / (replays * len(fns))


def build_checkouts(sources, parents=()) -> dict[str, Path]:
    """``{build name: csrc directory}``: each checkout in ``parents`` (a
    root holding ``zraytrace_tpu_torch/csrc``), named by its directory,
    then this one as ``THIS``. Every source is compiled for every
    checkout, one nvcc each, all at once, and each kernel's registers and
    spills from ``-Xptxas -v`` are printed as ``[ptxas] <build> <source>
    <kernel>: ...`` lines."""
    from zraytrace_tpu_torch.ops.build import CSRC, build

    jobs = {Path(p).name: Path(p).resolve() / "zraytrace_tpu_torch" / "csrc" for p in parents}
    jobs[THIS] = CSRC
    with concurrent.futures.ThreadPoolExecutor(len(jobs) * len(sources)) as pool:
        futures = {(name, src): pool.submit(build, src, csrc)
                   for name, csrc in jobs.items() for src in sources}
        for (name, src), f in futures.items():
            entry = None
            for line in f.result()["log"].splitlines():
                if "entry function" in line:
                    entry = line.split("'")[1] if "'" in line else line.strip()
                elif "registers" in line or "spill" in line:
                    print(f"[ptxas] {name} {src} {entry}: {line.strip()}", flush=True)
    return jobs


def ab_rounds(timers: dict) -> dict[str, list[float]]:
    """``{name: [ms, ms]}``: each timer (a function of no arguments that
    returns milliseconds) run once in the order given and once in reverse
    (A B, B A), so that a drift of the card's clock over the run weighs on
    every build alike."""
    times = {name: [] for name in timers}
    for order in (list(timers), list(timers)[::-1]):
        for name in order:
            times[name].append(timers[name]())
    return times


def bind(source: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """The C entry ``symbol`` of ``csrc/<source>.cu``, built on first use
    (``ops/build.py``), with its argument types set."""
    from zraytrace_tpu_torch.ops.build import load

    lib = load(source)
    fn = getattr(lib, symbol)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        lib.zr_error_string.argtypes = [ctypes.c_int]
        lib.zr_error_string.restype = ctypes.c_char_p
    return fn


def launch(source: str, fn, *args) -> None:
    """Call a C launch entry on the current stream and raise on its error
    code (a refused launch never runs)."""
    err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        from zraytrace_tpu_torch.ops.build import load

        msg = load(source).zr_error_string(err).decode()
        raise RuntimeError(f"{source} launch failed: {msg}")


def as_int32_bits(v: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> an int32 tensor of the same bits (the
    plain versions' uint32 results; torch has no full uint32 arithmetic)."""
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


def compare(name: str, got: torch.Tensor, want: torch.Tensor, rtol: float = 0.0,
            atol: float = 0.0) -> float:
    """Raise ``ProbeMismatch`` unless ``got`` equals ``want`` (integers, or
    floats with both tolerances 0: bit for bit, infinities included) or lies
    within ``atol + rtol * |want|``; returns the largest finite |diff|."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise ProbeMismatch(f"{name}: {got.dtype}{tuple(got.shape)} vs "
                            f"{want.dtype}{tuple(want.shape)}")
    if not got.is_floating_point():
        bad = int((got != want).sum())
        if bad:
            raise ProbeMismatch(f"{name}: {bad} of {got.numel()} integers differ")
        return 0.0
    same_inf = (got == want) | (torch.isnan(got) & torch.isnan(want))
    finite = torch.isfinite(got) & torch.isfinite(want)
    diff = torch.where(finite, (got - want).abs(), torch.zeros_like(got))
    ok = same_inf | (finite & (diff <= atol + rtol * want.abs()))
    bad = int((~ok).sum())
    if bad:
        raise ProbeMismatch(f"{name}: {bad} of {got.numel()} values differ beyond "
                            f"rtol {rtol}, atol {atol} (max finite |diff| "
                            f"{float(diff.max()):.3g})")
    return float(diff.max()) if diff.numel() else 0.0


def format_row(row: dict, card: str | None = None) -> str:
    """One line per variant, as the TPU tools printed them."""
    where = f" on {card}" if card else f" ({row['device']})"
    note = f"; {row['note']}" if row.get("note") else ""
    if row["ms"] is None and row["plain_ms"] is None:  # a check that times nothing
        return f"[OK] {row['probe']} {row['variant']:<18} {row['note']}{where}"
    if row["ms"] is None:
        return (f"[plain] {row['probe']} {row['variant']:<18} plain {row['plain_ms']:.4f} ms "
                f"per launch (host clock){where}")
    if row["plain_ms"] is None and row["max_abs_err"] is None:  # a library call's row
        return (f"[library] {row['probe']} {row['variant']:<18} {row['ms']:.5f} ms per call, "
                f"{row['per']:.4f} {row['unit']}{note}{where}")
    if row.get("library_ms") is not None:
        note = f"; library {row['library_ms']:.5f} ms{note}"
    # a row without a plain time holds its kernel to what its note names
    plain = ("" if row["plain_ms"] is None
             else f"; plain {row['plain_ms']:.4f} ms; kernel vs plain")
    return (f"[OK] {row['probe']} {row['variant']:<18} {row['ms']:.5f} ms per launch, "
            f"{row['per']:.4f} {row['unit']}{plain} max |diff| {row['max_abs_err']:.3g}"
            f"{note}{where}")


def main_for(measure, variants, argv) -> int:
    """Command-line body shared by the probes: ``[--cpu] [variant ...]``."""
    device, names = device_from_argv(argv)
    chosen = select(names, variants)
    card = card_line() if device.type == "cuda" else None
    if card:
        print(f"gpu: {card}", flush=True)
    for row in measure(device, chosen):
        print(format_row(row, card), flush=True)
    return 0
