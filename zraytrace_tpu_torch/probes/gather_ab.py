"""How do the gather and capability probe kernels compare with another
checkout's on the same inputs, and what bounds them?

The port's own measurement beside two probes (``gather_probe3``,
``pallas_probe``). It builds ``csrc/probe_gather3.cu`` and
``csrc/probe_pallas.cu`` of this checkout and, with ``--parent DIR``
(repeatable), the two sources of the checkout at ``DIR`` as they are, and
times each build on the probes' own inputs (``make_inputs``): every kernel
variant of both probes, the scratch rows, and ``dg0`` on a 65,536-row
table (``EXTRA``), whose column slab no block's shared memory holds.

Each launch is timed as a CUDA graph of ``PER_GRAPH`` launches on
outputs allocated once, replayed ``REPLAYS`` times (device time; the same
inputs every launch, so the tables are warm in L2). Beside each row this
checkout's launch floor: a kernel that does nothing, launched with the
row's grid, block and shared memory, timed the same way. Every build's
output must equal the plain version's, bit for bit. The builds run in
the order given (the parents, then this checkout) and then in reverse
(parent, this, this, parent); each time is the mean of the two rounds.
Beside them, this build's ``dg0`` at 0, 8 and 32 rounds (``SPLIT_ROUNDS``):
what copying the slab costs against the sums. The SM clock is read with
``nvidia-smi`` while ``dg0_4096`` runs. Last,
``cuobjdump -sass`` of this build (``body_ab.parse_sass``, ``loops``)
and each row's bounds: ``bound_ms`` (bytes at 3.35 TB/s against the
operations at 67 TFLOP/s, ``probes/bounds.py``), ``bound_unfused_ms`` (one
instruction per FP32 operation) and ``bound_issue_ms`` (this build's
counted SASS at one warp instruction a clock on each scheduler, at the
measured clock; see ``issue_instructions``).

    python -m zraytrace_tpu_torch.probes.gather_ab [--parent DIR ...]

Needs a CUDA device. Prints ``[ptxas]`` lines per build, source and
kernel, ``[ab]`` lines per row and build with the floor, ``[split]``,
``[clock]``, ``[sass]`` and ``[loop]`` lines per kernel, ``[bounds]``
lines per row, and one JSON line.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

import torch

from zraytrace_tpu_torch.ops.build import load
from zraytrace_tpu_torch.probes import body_ab, gather_probe3, pallas_probe
from zraytrace_tpu_torch.probes.bounds import SCHEDULERS, bound, issue_ms, unfused_ms
from zraytrace_tpu_torch.probes.common import (THIS, ab_rounds, build_checkouts, card_line,
                                               time_graph_calls)

SOURCES = ("probe_gather3", "probe_pallas")
PER_GRAPH = 20
REPLAYS = 10
FLOOR = "floor"  # the name of the launch floor's timer beside the builds
# gather rows beyond the probe's variants: (mode, rows)
EXTRA = {"dg0_65536": ("dg0", 65536)}
# dg0 of this build at these rounds (what the slab's copy costs against the sums)
SPLIT_ROWS, SPLIT_ROUNDS = (1024, 4096), (0, 8, 32)
# each row's kernel in this checkout's SASS: parts of the mangled name,
# the first that names one function wins (a redesign's name first)
SASS_KERNELS = {
    "dg0_1024": ("dg0_slab_kernelILi8E", "dg_kernelILi0E"),
    "dg0_4096": ("dg0_slab_kernelILi8E", "dg_kernelILi0E"),
    "dg0_65536": ("dg0_l2_kernel", "dg_kernelILi0E"),
    "dg1_1024": ("dg1_kernel", "dg_kernelILi1E"),
    "roll_1024": ("roll_kernelILb0E",),
    "roll_dyn_1024": ("roll_kernelILb1E",),
    "tex128": ("tex_kernel",),
    **{f"{v}{s}": (f"{k}_kernelILi{q}E", f"{k}_kernel") for s, q in (("", 1), ("_1m", 4))
       for v, k in (("while_loop", "while"), ("prng", "philox"), ("pcg4d_parity", "pcg4d"))},
    **{f"{v}{s}": (f"gather_kernelILi{q}E", f"gather{d}_kernel") for s, q in (("", 1), ("_1m", 4))
       for v, d in (("vmem_gather_1d", "1d"), ("vmem_gather_2d_reshape", "2d"))},
}

_I, _P = ctypes.c_int, ctypes.c_void_p


def _typed(lib, name: str, argtypes):
    fn = getattr(lib, name, None)
    if fn is not None:
        fn.argtypes, fn.restype = argtypes, _I
    return fn


class Build:
    """The two probes' entries of one build, launched by ctypes on outputs
    allocated once per input (so a CUDA graph holds only the kernels). A
    build from before the launch floor's entries has ``floor_*`` None."""

    def __init__(self, name: str, csrc: Path):
        self.name = name
        g, p = load("probe_gather3", csrc), load("probe_pallas", csrc)
        self.gather = _typed(g, "zr_probe_gather3_launch", [_I, _P, _P, _P, _P, _I, _I, _P])
        self.scratch = _typed(g, "zr_probe_scratch_launch", [_P, _P, _I, _P])
        self.floor_gather = _typed(g, "zr_probe_gather3_floor", [_I, _I, _I, _P])
        self.pallas = _typed(p, "zr_probe_pallas_launch", [_I, _P, _P, _P, _I, _I, _P])
        self.floor_pallas = _typed(p, "zr_probe_pallas_floor", [_I, _I, _P])

    def _run(self, what: str, fn, *args) -> None:
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{self.name}: {what} launch failed ({err})")

    def gather_call(self, mode: str, tbl, idx, idx2, rounds: int = gather_probe3.K):
        out = torch.empty(tbl.shape, dtype=tbl.dtype, device=tbl.device)
        ptr = lambda t: None if t is None else t.data_ptr()
        m, rows = gather_probe3.MODES.index(mode), tbl.shape[0]

        def launch():  # holds the inputs, whose memory the kernel reads
            self._run(mode, self.gather, m, tbl.data_ptr(), ptr(idx), ptr(idx2), out.data_ptr(),
                      rows, rounds)
        return launch, out

    def scratch_call(self, x, nbytes: int):
        out = torch.empty_like(x)
        return lambda: self._run("scratch", self.scratch, x.data_ptr(), out.data_ptr(),
                                 nbytes), out

    def pallas_call(self, mode: str, x, idx, param: int):
        lanes = x if idx is None else idx
        out = torch.empty(lanes.shape, dtype=torch.int32 if mode == "philox" else torch.float32,
                          device=x.device)
        m, ids = pallas_probe.MODES.index(mode), None if idx is None else idx.data_ptr()

        def launch():
            self._run(mode, self.pallas, m, x.data_ptr(), ids, out.data_ptr(), out.numel(),
                      int(param))
        return launch, out

    def gather_floor(self, mode: str | None, rows: int, nbytes: int = 0):
        if self.floor_gather is None:
            return None
        m = len(gather_probe3.MODES) if mode is None else gather_probe3.MODES.index(mode)
        return lambda: self._run("floor", self.floor_gather, m, rows, nbytes)

    def pallas_floor(self, mode: str, n: int):
        if self.floor_pallas is None:
            return None
        m = pallas_probe.MODES.index(mode)
        return lambda: self._run("floor", self.floor_pallas, m, n)


def _graph_timer(launch, dev):
    return lambda: time_graph_calls([launch] * PER_GRAPH, dev, REPLAYS)


def cases(dev, builds):
    """``[(probe, variant, {timer name: timer}, work)]`` for every row,
    each build checked against the plain version first (raises where one
    differs)."""
    this = builds[-1]
    out = []

    def add(probe, name, calls, want, floor, w):
        timers = {}
        for b, call in zip(builds, calls):
            if call is None:
                continue
            launch, got = call
            launch()
            torch.cuda.synchronize(dev)
            if not torch.equal(got, want):
                raise RuntimeError(f"{probe} {name} {b.name}: differs from the plain version")
            timers[b.name] = _graph_timer(launch, dev)
        if floor is not None:
            timers[FLOOR] = _graph_timer(floor, dev)
        out.append((probe, name, timers, w))

    shapes = {**gather_probe3.SHAPES, **EXTRA}
    for name, (mode, rows) in shapes.items():
        variant = name if name in gather_probe3.SHAPES else "dg0_1024"
        _, tbl, idx, idx2 = gather_probe3.make_inputs(variant, dev, rows=rows)
        want = gather_probe3.gather3_plain(mode, tbl, idx, idx2)
        add("gather_probe3", name, [b.gather_call(mode, tbl, idx, idx2) for b in builds], want,
            this.gather_floor(mode, rows), gather_probe3.work(mode, rows))
    x = torch.ones(gather_probe3.L, dtype=torch.float32, device=dev)
    for name, nbytes in gather_probe3.SCRATCH.items():
        nbytes = nbytes or gather_probe3.smem_optin(dev)
        # a build from before the floor's entries sets the opt-in at every
        # launch, which a graph capture need not accept: not timed
        add("gather_probe3", name, [b.scratch_call(x, nbytes) if b.floor_gather else None
                                    for b in builds],
            torch.full_like(x, 3.0), this.gather_floor(None, 0, nbytes),
            dict(flops=0, nbytes=2 * 4 * gather_probe3.L, int_ops=0))
    for name in pallas_probe.VARIANTS:
        mode, xs, idx, param = pallas_probe.make_inputs(name, dev)
        n = (xs if idx is None else idx).numel()
        want = pallas_probe.pallas_kernel_plain(mode, xs, idx, param)
        add("pallas_probe", name, [b.pallas_call(mode, xs, idx, param) for b in builds], want,
            this.pallas_floor(mode, n), pallas_probe.work(mode, n, param))
    return out


def measure(dev, parents=()) -> dict:
    """``{"rows", "split", "clock_mhz"}``: rows ``{"probe", "variant",
    "build", "ms", "rounds"}`` (the floor's as build ``"floor"``), with each
    row's work; ``split`` ``{(rows, rounds): ms}``, this build's dg0 at
    ``SPLIT_ROUNDS``."""
    builds = [Build(name, csrc) for name, csrc in build_checkouts(SOURCES, parents).items()]
    rows = []
    for probe, name, timers, w in cases(dev, builds):
        for b, ms in ab_rounds(timers).items():
            rows.append(dict(probe=probe, variant=name, build=b, ms=sum(ms) / len(ms), rounds=ms,
                             work=w))
    split = {}
    for n_rows in SPLIT_ROWS:
        _, tbl, idx, _ = gather_probe3.make_inputs("dg0_1024", dev, rows=n_rows)
        for rounds in SPLIT_ROUNDS:
            launch, got = builds[-1].gather_call("dg0", tbl, idx, None, rounds=rounds)
            launch()
            if not torch.equal(got, gather_probe3.gather3_plain("dg0", tbl, idx, rounds=rounds)):
                raise RuntimeError(f"dg0 rows {n_rows} rounds {rounds}: differs from plain")
            split[(n_rows, rounds)] = _graph_timer(launch, dev)()
    # the SM clock while this build's dg0_4096 runs
    _, tbl, idx, _ = gather_probe3.make_inputs("dg0_4096", dev)
    launch, _ = builds[-1].gather_call("dg0", tbl, idx, None)
    launch()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(PER_GRAPH):
            launch()
    return dict(rows=rows, split=split, clock_mhz=body_ab.sm_clock_mhz(graph.replay, dev))


def _loads(instrs) -> int:
    """Loads of table data: ``LDS`` and ``LDG`` (not the copies
    ``LDGSTS`` or matrix loads ``LDSM``)."""
    return sum(op.startswith(("LDS", "LDG")) and not op.startswith(("LDGSTS", "LDSM"))
               for _, op, *_ in instrs)


def _store_lanes(instrs) -> int:
    """4-byte lanes written by the ``STG`` instructions (``STG.E.128``: 4)."""
    lanes = 0
    for _, op, *_ in instrs:
        if op.startswith("STG"):
            width = op.rsplit(".", 1)[-1]
            lanes += int(width) // 32 if width.isdigit() else 1
    return lanes


def issue_instructions(instrs, variant: str, n: int, rounds: int = gather_probe3.K,
                       trips: int = pallas_probe.TRIPS) -> float | None:
    """Warp instructions a launch issues, from one kernel's SASS (this
    build's): static counts of a loop's hot path (``_loops``, slow paths
    left out) times how often it runs for ``n`` lanes:

    - row gathers and rolls: the loop without stores that reads the most
      table words a trip, as if every read ran at its rate: ``n x rounds /
      32 / (its loads)`` warp-trips (a staggered sum's end steps and a
      thread's set-up are left out);
    - ``while``: the loop with the adds and no store runs ``trips / (its
      adds a lane)`` times for each trip of the loop that stores;
    - the rest: the widest loop that stores ``s`` 4-byte lanes a thread
      runs ``n / (32 s)`` warp-trips, or, without one, the whole function
      (its padding included) ``n / 32 / s`` times.

    None where the SASS does not fit its model."""
    lps = _loops(instrs)
    stores = [lp for lp in lps if lp["hot_store_lanes"]]
    widest = lambda xs, key: max(xs, key=lambda lp: lp[key] if key else lp["hot"].get("all", 0))
    if variant.startswith(("dg", "roll")):
        reads = [lp for lp in lps if not lp["hot_store_lanes"] and lp["hot_loads"]]
        if not reads:
            return None
        lp = widest(reads, "hot_loads")
        return lp["hot"].get("all", 0) * n * rounds / 32 / lp["hot_loads"]
    if variant.startswith("while"):
        inner = [lp for lp in lps if not lp["hot_store_lanes"] and lp["hot"].get("FADD", 0)]
        if not inner or not stores:
            return None
        inner, outer = widest(inner, None), widest(stores, None)
        lanes = outer["hot_store_lanes"]
        per_trip = outer["hot"].get("all", 0) + inner["hot"].get("all", 0) * (
            trips * lanes / inner["hot"]["FADD"] - 1)
        return per_trip * n / (32 * lanes)
    if stores:
        lp = widest(stores, None)
        return lp["hot"].get("all", 0) * n / (32 * lp["hot_store_lanes"])
    lanes = _store_lanes(instrs)
    return body_ab.count_ops(instrs).get("all", 0) * n / (32 * lanes) if lanes else None


def _loops(instrs) -> list[dict]:
    """``body_ab.loops`` with each hot path's table loads (``hot_loads``)
    and stored lanes (``hot_store_lanes``), the trailing self-branch left
    out."""
    out = []
    for lp in body_ab.loops(instrs, with_instrs=True):
        hot = lp.pop("hot_instrs")
        if lp["head"] != lp["tail"]:  # not the branch to itself that ends a function
            out.append(dict(lp, hot_loads=_loads(hot), hot_store_lanes=_store_lanes(hot)))
    return out


def sass_report() -> dict:
    """``{function: {"ops", "loops", "instrs"}}`` for every kernel of this
    checkout's two builds (``_loops``)."""
    return {fname: dict(ops=body_ab.count_ops(instrs), loops=_loops(instrs), instrs=instrs)
            for src in SOURCES
            for fname, instrs in body_ab.parse_sass(body_ab.sass_text(src)).items()}


def kernel_for(report: dict, variant: str):
    """This build's function for a row (``SASS_KERNELS``), or None."""
    key = variant if variant in SASS_KERNELS else next(
        (k for k in SASS_KERNELS if variant.startswith(k)), None)
    for part in SASS_KERNELS.get(key, ()):
        names = [f for f in report if part in f]
        if len(names) == 1:
            return names[0]
    return None


def bounds(report: dict, rows: list, clock_hz: float) -> dict:
    """``{(probe, variant): {...}}`` for this build's rows: ``bound_ms`` and
    ``bound_by``, ``bound_unfused_ms``, ``bound_issue_ms`` and
    ``issue_instr`` (None without a model), ``floor_ms``, ``ms``, the
    kernel read and ``issue_share`` (the issue bound over the time)."""
    floors = {(r["probe"], r["variant"]): r["ms"] for r in rows if r["build"] == FLOOR}
    out = {}
    for r in rows:
        if r["build"] != THIS:
            continue
        w, key = r["work"], (r["probe"], r["variant"])
        b_ms, b_by = bound(w["flops"], w["nbytes"], int_ops=w["int_ops"])
        fname = kernel_for(report, r["variant"])
        n = row_lanes(r)
        instr = None if fname is None or n is None else issue_instructions(
            report[fname]["instrs"], r["variant"], n)
        i_ms = None if instr is None else issue_ms(instr, clock_hz)
        out[key] = dict(ms=r["ms"], floor_ms=floors.get(key), bound_ms=b_ms, bound_by=b_by,
                        bound_unfused_ms=unfused_ms(w["flops"], w["int_ops"]),
                        bound_issue_ms=i_ms, issue_instr=instr, kernel=fname,
                        issue_share=None if i_ms is None else i_ms / r["ms"])
    return out


def row_lanes(row) -> int | None:
    """Lanes (elements) of a row's launch."""
    if row["probe"] == "pallas_probe":
        return pallas_probe.SHAPES[row["variant"]][1] * pallas_probe.L
    shape = {**gather_probe3.SHAPES, **EXTRA}.get(row["variant"])
    return None if shape is None else shape[1] * gather_probe3.L


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, action="append", default=[],
                    help="root of another checkout to time beside (repeatable)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if not torch.cuda.is_available():
        print("gather_ab: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"gpu: {card}", flush=True)
    result = measure(dev, args.parent)
    floors = {(r["probe"], r["variant"]): r["ms"] for r in result["rows"] if r["build"] == FLOOR}
    for r in result["rows"]:
        if r["build"] == FLOOR:
            continue
        fl = floors.get((r["probe"], r["variant"]))
        print(f"[ab] {r['probe']} {r['variant']} {r['build']}: {r['ms']:.5f} ms per launch "
              f"(rounds {', '.join(f'{x:.5f}' for x in r['rounds'])}; equal to plain; floor "
              f"{'-' if fl is None else f'{fl:.5f}'} ms) on {card}", flush=True)
    if not result["clock_mhz"]:
        print("gather_ab: nvidia-smi read no SM clock", file=sys.stderr)
        return 1
    mhz = sorted(result["clock_mhz"])[len(result["clock_mhz"]) // 2]
    for (n_rows, rounds), ms in result["split"].items():
        print(f"[split] dg0 {n_rows} rows, {rounds} rounds, {THIS}: {ms:.5f} ms per launch",
              flush=True)
    print(f"[clock] SM clock under dg0_4096's load: {result['clock_mhz']} MHz", flush=True)
    report = sass_report()
    for fname, rep in report.items():
        print(f"[sass] {fname}: {rep['ops']}", flush=True)
        for lp in rep["loops"]:
            print(f"[loop] {fname} 0x{lp['head']:x}-0x{lp['tail']:x}: {lp['ops']}; hot "
                  f"{lp['hot']}; loads {lp['hot_loads']}, stored lanes {lp['hot_store_lanes']}",
                  flush=True)
    b = bounds(report, result["rows"], mhz * 1e6)
    for (probe, variant), v in b.items():
        fmt = lambda x, f=".5f": "-" if x is None else format(x, f)
        print(f"[bounds] {probe} {variant}: {v['ms']:.5f} ms, floor {fmt(v['floor_ms'])}; bound "
              f"{v['bound_ms']:.5f} ms ({v['bound_by']}), unfused {v['bound_unfused_ms']:.5f}, "
              f"issue {fmt(v['bound_issue_ms'])} ({v['kernel']}, {fmt(v['issue_instr'], '.0f')} "
              f"warp instructions at {mhz} MHz)", flush=True)
    for rep in report.values():
        del rep["instrs"]
    rows = [{k: v for k, v in r.items() if k != "work"} for r in result["rows"]]
    print(json.dumps({"gather_ab": rows, "clock_mhz": result["clock_mhz"],
                      "split": {f"{r} {k}": ms for (r, k), ms in result["split"].items()},
                      "bounds": {f"{p} {v}": x for (p, v), x in b.items()}, "sass": report,
                      "card": card, "schedulers": SCHEDULERS}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
