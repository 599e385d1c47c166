"""Run one cell of ``BENCHMARK.json`` and print its result.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell's configuration, traffic mix,
per-layer readers and limits are found by name (``benchmark/__init__.py``).
The run builds the program's side (set-up, ``setup_s``: from the start of
this process to the start of the window), drives the window for
``--seconds``, and with ``--trace 1`` profiles a few more calls. Once the
window has closed and the device's peak memory is read, it frees the
program's state and compares the window's outputs with the reference.
The comparisons go to standard error as the last lines, each number
beside its limit, and into the result's last key, ``checks``. The result
is one JSON line, the last of standard output: the end-to-end metrics
with ``--trace 0``, the per-layer ones with ``--trace 1``.

The cell gets the cards its ``chips`` asks for, ``cuda:0`` up, and the
result's ``device`` block counts the distinct cards the run really used
(``cards.py``), from each card's record: taken here for a driver that
works in this process, or returned by a driver whose ranks work in
processes of their own (``drivers/__init__.py``).

Exits, each with no result: 3 without enough CUDA devices for the cell;
4 with JAX or the JAX package loaded at the end; 5 where the run used
fewer distinct cards than the cell asks for, a card twice, or cards of
different kinds (standard error names the handed and the used cards).
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

import torch  # noqa: E402

from benchmark import cards  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "zraytrace_tpu")


def load_cell(root: Path, workload: str) -> SimpleNamespace:
    """The cell's entry of ``root/BENCHMARK.json`` with its configuration,
    traffic mix and limits, each read from its own file by name."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    here = root / "benchmark"
    read = lambda p: json.loads(p.read_text())
    per_layer = [m for m in bench["per_layer"] if workload in m.get("workloads", [workload])]
    return SimpleNamespace(
        name=workload, entry=w, root=root, config=read(here / "configs" / f"{w['config']}.json"),
        traffic=read(here / "traffic" / f"{w['traffic']}.json"),
        limits=read(here / "limits" / f"{workload}.json"), per_layer=per_layer,
        end_to_end=[m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])])


def driver(kind: str):
    from importlib import import_module

    return import_module(f"benchmark.drivers.{kind}")


def reader(root: Path, metric: str):
    """The per-layer metric's reader, ``metrics/<metric>.py``'s ``read``."""
    path = root / "benchmark" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def cuda_cards(chips: int):
    """The ``chips`` CUDA devices a cell is handed, or None (and why, on
    standard error) where fewer are visible."""
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < chips:
        print(f"benchmark: the cell needs {chips} CUDA device(s); {have} available",
              file=sys.stderr)
        return None
    return [torch.device("cuda", i) for i in range(chips)]


def hand(cell: SimpleNamespace, seed: int, seconds: float, trace: bool, devices: list) -> None:
    """Set what a driver reads: the run's arguments and its cards
    (``cell.devices``; ``cell.device`` the first)."""
    cell.seed, cell.seconds, cell.trace = seed, seconds, trace
    cell.devices, cell.device = list(devices), devices[0]


def run_cell(cell: SimpleNamespace, seed: int, seconds: float, trace: bool, devices) -> dict:
    """Drive the cell on ``devices`` and check it: the result line's
    fields, and the numbers compared, each with its limit. Raises
    ``cards.WrongCards``, before the check, where the run did not use the
    cards its cell asks for."""
    hand(cell, seed, seconds, trace, devices)
    res = driver(cell.traffic["kind"]).run(cell)
    setup_s = res["setup_end"] - T_START
    if torch.device(cell.device).type == "cuda":
        handed = [cards.record(d, res.get("profile")) for d in cell.devices]
        dev = cards.block(res.get("devices") or handed, handed, cell.entry["chips"], trace)
    else:  # the host, in tests: no card to count
        dev = dict(platform="cpu", kind="cpu", count=0, memory_peak_bytes=0,
                   host_cpu=cards.host_cpu())
        if trace:
            dev.update(busy_s=res["profile"]["busy_s"], window_s=res["profile"]["window_s"])
    t0 = time.perf_counter()
    numbers = res.pop("check")()
    gc.collect()
    # a number that is not finite (a NaN gradient) is no reading, and fails
    checks = {k: dict(value=v if math.isfinite(v) else None, limit=cell.limits[k])
              for k, v in numbers.items()}
    print(f"# check took {time.perf_counter() - t0:.3f} s", file=sys.stderr)
    out = dict(correct=all(c["value"] is not None and c["value"] <= c["limit"]
                           for c in checks.values()),
               attempted=res["attempted"], failed=res["failed"])
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    if trace:
        res.update(cell=cell, setup_s=setup_s)
        metrics = {}
        for m in cell.per_layer:
            v = reader(cell.root, m["name"])(res)
            if v is not None:
                metrics[m["name"]] = dict(value=v, unit=units[m["name"]])
        out.update(metrics=metrics, device=dev, breakdown=res["profile"]["breakdown"])
    else:
        vals = dict(res["metrics"], setup_s=setup_s)
        out.update(metrics={m["name"]: dict(value=vals[m["name"]], unit=units[m["name"]])
                            for m in cell.end_to_end}, device=dev)
    out["checks"] = checks
    print(f"# {cell.name}: {res['attempted']} in {res['window_s']:.6f} s of window, set-up "
          f"{setup_s:.6f} s, {dev}", file=sys.stderr)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = load_cell(ROOT, args.workload)
    devices = cuda_cards(cell.entry["chips"])
    if devices is None:
        return 3
    try:
        out = run_cell(cell, args.seed, args.seconds, bool(args.trace), devices)
    except cards.WrongCards as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 5
    found = forbidden_modules()
    if found:
        print(f"benchmark: loaded {found}: the port must run without JAX", file=sys.stderr)
        return 4
    for k, c in out["checks"].items():
        print(f"check {k} = {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
