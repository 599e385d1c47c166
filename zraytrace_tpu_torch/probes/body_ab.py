"""How do the bounce-body and overlap probe kernels compare with another
checkout's on the same inputs, and what bounds them?

The port's own measurement beside two probes (``body_probe``,
``overlap_probe``). It builds ``csrc/probe_body.cu`` and
``csrc/probe_overlap.cu`` of this checkout and, with ``--parent DIR``
(repeatable), the two sources of the checkout at ``DIR`` as they are, and
times each build on the probes' own inputs:

- ``body``: every body variant at the tool's 1024 x 128 lanes, ``B = 8``
  iterations a launch (``body_probe.make_inputs``), ``K = 24`` launches a
  CUDA graph;
- ``overlap``: the probe's four rows (``gather``, ``kernel``,
  ``both_one_stream``, ``both_streams``), ms per rep of 30, each a CUDA
  graph (``overlap_probe.measure`` with the build's kernel);
- ``scaling``: ``full`` and the overlap kernel (760 iterations) at half,
  once and twice the tool's lanes, the same work per lane. Where the time
  grows with the lanes the kernel is bound by issue; where it stays flat,
  by latency.

Every build's outputs must equal the plain version's, bit for bit. The
builds run in the order given (the parents, then this checkout) and then
in reverse (parent, this, this, parent); each time is the mean of the two
rounds. The SM clock is read with ``nvidia-smi`` while ``full`` runs. Last,
``cuobjdump -sass`` of this build: each kernel's instructions by opcode
(``SASS_OPS``) and, for each loop (a backward branch), the instructions
from its head to the branch: a static count of what a warp issues per
trip, both sides of a branch counted. The probes' three bounds
(``probes/bounds.py``) are priced from them: the FP32 rate, one
instruction per multiply or add, and the issue rate of the counted SASS
at the measured clock.

    python -m zraytrace_tpu_torch.probes.body_ab [--parent DIR ...]

Needs a CUDA device. Prints ``[ptxas]`` lines per build, source and
kernel, ``[ab]`` lines per input and build, ``[scaling]``, ``[clock]``,
``[sass]``, ``[loop]`` and ``[bounds]`` lines, and one JSON line.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

from zraytrace_tpu_torch.ops.build import build, find_nvcc, load
from zraytrace_tpu_torch.probes import body_probe, overlap_probe
from zraytrace_tpu_torch.probes.bounds import SCHEDULERS, bound, issue_ms, unfused_ms
from zraytrace_tpu_torch.probes.common import (THIS, ab_rounds, build_checkouts, card_line,
                                               time_graph_calls)

SOURCES = ("probe_body", "probe_overlap")
SCALES = {"half": 512, "one": 1024, "two": 2048}  # rows of 128 lanes
BODY_REPLAYS = 10
OVERLAP_REPLAYS = 10
# opcodes counted (a prefix: FFMA counts FFMA.FTZ too)
SASS_OPS = ("FFMA", "FMUL", "FADD", "FSEL", "FSETP", "FMNMX", "FCHK", "MUFU", "F2I", "I2F",
            "FRND", "IMAD", "IADD3", "LOP3", "SHF", "ISETP", "SEL", "LDS", "LDG", "STG",
            "BRA", "CALL", "BSSY", "BSYNC", "VOTE")
# the kernels whose SASS is counted: (source, mangled-name part)
SASS_KERNELS = {f"body_{v}": ("probe_body", f"body_kernelILi{i}E")
                for i, v in enumerate(body_probe.VARIANTS)}
SASS_KERNELS["overlap"] = ("probe_overlap", "overlap_kernel")

_I, _P = ctypes.c_int, ctypes.c_void_p
_ADDR = re.compile(r"/\*([0-9a-f]{4,})\*/")
_PRED = re.compile(r"^@!?U?P[T0-9]+\s+")


class Build:
    """The two probe kernels of one build, launched by ctypes on outputs
    allocated once per input (so a CUDA graph holds only the kernels)."""

    def __init__(self, name: str, csrc: Path):
        self.name = name
        self.body = load("probe_body", csrc).zr_probe_body_launch
        self.body.argtypes = [_I, _P, _I, _P, _I, _P, _P, _P, _P, _P, _P, _I,
                              ctypes.POINTER(ctypes.c_int), _I, _P]
        self.body.restype = _I
        self.overlap = load("probe_overlap", csrc).zr_probe_overlap_launch
        self.overlap.argtypes = [_P, _P, _I, _I, _P]
        self.overlap.restype = _I

    def body_call(self, variant: str, state, base, tables, params):
        sph, mats, cam = (t.contiguous() for t in tables)
        ins = (torch.stack(state[:body_probe.N_F32]).contiguous(),
               torch.stack(state[body_probe.N_F32:]).contiguous())
        outs = torch.empty_like(ins[0]), torch.empty_like(ins[1])
        prm = (ctypes.c_int * 10)(*(int(p) for p in params))

        def launch():  # holds ins, outs and the tables, whose memory the kernel uses
            err = self.body(body_probe.VARIANTS.index(variant), sph.data_ptr(), sph.shape[0],
                            mats.data_ptr(), mats.shape[0], cam.data_ptr(), base.data_ptr(),
                            ins[0].data_ptr(), ins[1].data_ptr(), outs[0].data_ptr(),
                            outs[1].data_ptr(), base.numel(), prm, body_probe.B,
                            torch.cuda.current_stream(base.device).cuda_stream)
            if err:
                raise RuntimeError(f"{self.name}: body launch failed ({err})")
        return launch, tuple(outs[0].unbind(0)) + tuple(outs[1].unbind(0))

    def overlap_kernel(self, x: torch.Tensor, iters: int = overlap_probe.ITERS) -> torch.Tensor:
        out = torch.empty_like(x)
        err = self.overlap(x.data_ptr(), out.data_ptr(), x.numel(), iters,
                           torch.cuda.current_stream(x.device).cuda_stream)
        if err:
            raise RuntimeError(f"{self.name}: overlap launch failed ({err})")
        return out


def parse_sass(text: str) -> dict[str, list[tuple[int, str, int | None, str]]]:
    """``cuobjdump -sass`` text -> ``{function: [(offset, opcode, branch
    target or None, instruction text)]}``; a target is read from a ``BRA``
    with a hexadecimal address."""
    funcs, cur = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            cur = funcs.setdefault(line.split("Function :", 1)[1].strip(), [])
            continue
        m = _ADDR.search(line)
        if cur is None or not m or line.lstrip()[:2] != "/*":
            continue
        body = line[m.end():].split(";")[0].strip()
        if not body or body.startswith("/*"):
            continue
        op = _PRED.sub("", body).split()[0]
        target = None
        if op.startswith("BRA"):
            t = re.search(r"\b0x([0-9a-f]+)\b", body)
            target = int(t.group(1), 16) if t else None
        cur.append((int(m.group(1), 16), op, target, body))
    return funcs


def count_ops(instrs) -> dict:
    """Instructions by opcode (``SASS_OPS`` prefixes) and in all
    (``all``)."""
    counts = collections.Counter()
    for _, op, *_ in instrs:
        counts["all"] += 1
        for name in SASS_OPS:
            if op.startswith(name):
                counts[name] += 1
                break
    return dict(counts)


def _blocks(instrs):
    """Basic blocks of one function's instructions: ``(start index, end
    index, successor start indices)``. A branch ends a block (a predicated
    one also falls through), as do ``EXIT`` and ``RET``; a call returns to
    the next instruction."""
    index = {off: k for k, (off, *_) in enumerate(instrs)}
    leaders = {0}
    for k, (off, op, t, text) in enumerate(instrs):
        if op.startswith(("BRA", "EXIT", "RET")):
            leaders.add(k + 1)
            if t in index:
                leaders.add(index[t])
    starts = sorted(x for x in leaders if x < len(instrs))
    blocks = {}
    for a, b in zip(starts, starts[1:] + [len(instrs)]):
        off, op, t, text = instrs[b - 1]
        succ = set()
        conditional = text.startswith("@") and not text.startswith("@PT")
        if op.startswith("BRA"):
            if t in index:
                succ.add(index[t])
            if conditional:
                succ.add(b)
        elif not op.startswith(("EXIT", "RET")) or conditional:
            succ.add(b)
        blocks[a] = (a, b, {x for x in succ if x < len(instrs)})
    return blocks


def loops(instrs, with_instrs: bool = False) -> list[dict]:
    """One entry per backward branch, the largest first: ``head`` and
    ``tail`` (the offsets of its target and of the branch), ``ops`` (the
    loop's instructions by ``count_ops``: the blocks on a path from the
    head to the branch, wherever the compiler placed them, each counted
    once, so both sides of every branch) and ``hot`` (the same without the slow
    paths: the blocks with a call or a store to local memory, ``CALL`` or
    ``STL``, as a called slow division, square root or body, or sinf's
    Payne-Hanek reduction, which keeps its product in local memory, and
    the blocks on no path from the head to the branch that avoids them),
    and ``trip_iters`` (sinf's reduction multiplies by 2/pi among
    the hot instructions: iterations per trip of the overlap chain); with
    ``with_instrs``, ``hot_instrs``, the hot path's instructions."""
    blocks = _blocks(instrs)
    start_of = {}
    for a, (_, b, _) in blocks.items():
        for k in range(a, b):
            start_of[k] = a
    pred = collections.defaultdict(set)
    for a, (_, _, succ) in blocks.items():
        for x in succ:
            pred[x].add(a)
    slow = {a for a, (_, b, _) in blocks.items()
            if any(instrs[k][1].startswith(("CALL", "STL")) for k in range(a, b))}

    def reach(seeds, edges, stop, avoid=frozenset()):
        seen, todo = set(seeds), list(seeds)
        while todo:
            x = todo.pop()
            if x == stop:
                continue
            for y in edges(x):
                if y not in seen and y not in avoid:
                    seen.add(y)
                    todo.append(y)
        return seen

    out = []
    for k, (off, op, t, _) in enumerate(instrs):
        if not (op.startswith("BRA") and t is not None and t <= off):
            continue
        head = start_of[next(j for j, ins in enumerate(instrs) if ins[0] == t)]
        tail = start_of[k]
        body = (reach({tail}, lambda x: pred[x], head) | {head}) & reach(
            {head}, lambda x: blocks[x][2], None)
        fast = body - slow
        fwd = reach({head} - slow, lambda x: blocks[x][2] & fast, None)
        back = reach({tail} - slow, lambda x: pred[x] & fast, head)
        hot = fwd & back
        ins = lambda bs: [instrs[j] for a in sorted(bs) for j in range(a, blocks[a][1])]
        out.append(dict(head=t, tail=off, ops=count_ops(ins(body)), hot=count_ops(ins(hot)),
                        trip_iters=sum("0.6366197" in text for *_, text in ins(hot))))
        if with_instrs:
            out[-1]["hot_instrs"] = ins(hot)
    return sorted(out, key=lambda r: -r["ops"].get("all", 0))


def find_kernel(funcs: dict, part: str) -> list:
    names = [n for n in funcs if part in n]
    if len(names) != 1:
        raise KeyError(f"{part!r}: {len(names)} functions match in the SASS")
    return funcs[names[0]]


def sass_text(source: str) -> str:
    """``cuobjdump -sass`` of this checkout's build of ``csrc/<source>.cu``."""
    tool = shutil.which("cuobjdump") or str(Path(find_nvcc()).with_name("cuobjdump"))
    return subprocess.run([tool, "-sass", str(build(source)["path"])], capture_output=True,
                          text=True, timeout=120, check=True).stdout


def sass_report() -> dict:
    """``{kernel: {"ops": counts, "loops": loops}}`` for ``SASS_KERNELS``
    in this checkout's builds."""
    texts = {src: parse_sass(sass_text(src)) for src in SOURCES}
    report = {}
    for name, (src, part) in SASS_KERNELS.items():
        instrs = find_kernel(texts[src], part)
        report[name] = dict(ops=count_ops(instrs), loops=loops(instrs))
    return report


def sm_clock_mhz(replay, dev, samples: int = 3) -> list[int]:
    """The SM clock (MHz) ``nvidia-smi`` reads while ``replay`` (a
    function enqueueing about a millisecond of device work) keeps the card
    busy for about a second per sample."""
    replay()
    torch.cuda.synchronize(dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    replay()
    end.record()
    torch.cuda.synchronize(dev)
    n = max(1, int(1000.0 / max(start.elapsed_time(end), 1e-3)))
    mhz = []
    for _ in range(samples):
        for _ in range(n):
            replay()
        proc = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,"
                               "nounits", "-i", str(dev.index or 0)], capture_output=True,
                              text=True, timeout=60)
        torch.cuda.synchronize(dev)
        if proc.returncode == 0 and proc.stdout.strip():
            mhz.append(int(float(proc.stdout.split()[0])))
    return mhz


def full_clock_mhz(dev) -> list[int]:
    """``sm_clock_mhz`` while this checkout's ``full`` runs: K launches on
    the tool's lanes in one CUDA graph, replayed."""
    state, base, tables, params = body_probe.make_inputs(dev)
    body_probe.body_chain("full", state, base, tables, params)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(body_probe.K):
            body_probe.body_chain("full", state, base, tables, params)
    return sm_clock_mhz(graph.replay, dev)


def sass_per_iteration(sass: dict, kernel: str) -> float:
    """Hot warp instructions per iteration of a ``sass_report`` kernel's
    widest loop: a trip of the overlap chain holds ``trip_iters``
    iterations, a trip of a body one."""
    loop = sass[kernel]["loops"][0]
    per_trip = loop["trip_iters"] if kernel == "overlap" else 1
    return loop["hot"].get("all", 0) / max(per_trip, 1)


def three_bounds(sass: dict, clock_hz: float, ms: dict) -> dict:
    """For ``probe_body``'s ``full`` (1024 x 128 lanes, B iterations) and
    ``probe_overlap``'s kernel (1024 x 128 elements, 760 iterations), the
    keys of ``ms`` (their measured ms per launch), from this build's
    ``sass_report`` and the SM clock:
    ``bound_ms`` (FP32 operations at 67 TFLOP/s against the bytes),
    ``bound_unfused_ms`` (one instruction per multiply, add or fused
    multiply-add), ``bound_issue_ms`` (the counted SASS, ``sass_per_iter``
    warp instructions an iteration, at the issue rate) and
    ``issue_reading`` (the warp instructions an iteration the measured time
    would issue at that rate)."""
    shapes = {"probe_body": ("body_full", body_probe.R_TOT * body_probe.L, body_probe.B),
              "probe_overlap": ("overlap", overlap_probe.L, overlap_probe.ITERS)}
    out = {}
    for name, t_ms in ms.items():
        kernel, lanes, iters = shapes[name]
        warps = -(-lanes // 32)
        hot = sass_per_iteration(sass, kernel)
        if name == "probe_body":
            fp, iops = body_probe.full_ops(lanes)
            b_ms = bound(fp, body_probe.full_bytes(lanes), int_ops=iops)[0]
            unf = unfused_ms(*body_probe.full_instructions(lanes))
        else:
            b_ms = bound(lanes * iters * overlap_probe.ITER_FLOPS, 2 * 4 * lanes)[0]
            unf = unfused_ms(lanes * iters * overlap_probe.ITER_INSTRS)
        out[name] = dict(bound_ms=b_ms, bound_unfused_ms=unf, sass_per_iter=hot,
                         bound_issue_ms=issue_ms(hot * warps * iters, clock_hz),
                         issue_reading=t_ms / 1e3 * SCHEDULERS * clock_hz / (warps * iters))
    return out


def _check(tag: str, got, want) -> None:
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise RuntimeError(f"{tag}: differs from the plain version")


def _graph_timer(launch, dev, replays: int, per: int):
    """ms per launch of ``per`` launches of ``launch`` in one CUDA graph."""
    return lambda: time_graph_calls([launch] * per, dev, replays)


def measure(dev, parents=()) -> dict:
    """``{"rows", "scaling", "clock_mhz"}``: rows ``{"input", "kernel",
    "build", "ms", "rounds"}``; raises where a build's outputs differ from
    the plain version's."""
    all_builds = [Build(name, csrc) for name, csrc in build_checkouts(SOURCES, parents).items()]
    cases = []  # (kernel, input, {build: timer})
    state, base, tables, params = body_probe.make_inputs(dev)
    for v in body_probe.VARIANTS:
        want = body_probe.body_chain_plain(v, state, base, tables, params)
        timers = {}
        for b in all_builds:
            launch, out = b.body_call(v, state, base, tables, params)
            launch()
            _check(f"body {v} {b.name}", out, want)
            timers[b.name] = _graph_timer(launch, dev, BODY_REPLAYS, body_probe.K)
        cases.append(("body", v, timers))
    x, _, _ = overlap_probe.make_inputs(dev)
    for scale, rows in SCALES.items():
        shape = (rows, body_probe.L)
        st, bs, tb, pr = body_probe.make_inputs(dev, shape=shape)
        want = body_probe.body_chain_plain("full", st, bs, tb, pr)
        xs = torch.cat([x, x.flip(0)])[:rows].contiguous()
        want_x = overlap_probe.overlap_kernel_plain(xs)
        timers_b, timers_o = {}, {}
        for b in all_builds:
            launch, out = b.body_call("full", st, bs, tb, pr)
            launch()
            _check(f"scaling body {scale} {b.name}", out, want)
            timers_b[b.name] = _graph_timer(launch, dev, BODY_REPLAYS, body_probe.K)
            _check(f"scaling overlap {scale} {b.name}", (b.overlap_kernel(xs),), (want_x,))
            timers_o[b.name] = _graph_timer(lambda b=b, xs=xs: b.overlap_kernel(xs), dev,
                                            OVERLAP_REPLAYS, 4)
        cases.append(("scaling_body", scale, timers_b))
        cases.append(("scaling_overlap", scale, timers_o))
    rows = []
    for kernel, name, timers in cases:
        times = ab_rounds(timers)
        rows += [dict(input=name, kernel=kernel, build=b, ms=sum(ms) / len(ms), rounds=ms)
                 for b, ms in times.items()]
    # the overlap probe's four rows, each build's kernel in its streams
    times = ab_rounds({b.name: lambda b=b: {r["variant"]: r["ms"] for r in overlap_probe.measure(
        dev, kernel=b.overlap_kernel)} for b in all_builds})
    for b, rounds in times.items():
        for v in overlap_probe.VARIANTS:
            ms = [r[v] for r in rounds]
            rows.append(dict(input=v, kernel="overlap", build=b, ms=sum(ms) / len(ms),
                             rounds=ms))
    return dict(rows=rows, clock_mhz=full_clock_mhz(dev))


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, action="append", default=[],
                    help="root of another checkout to time beside (repeatable)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if not torch.cuda.is_available():
        print("body_ab: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"gpu: {card}", flush=True)
    result = measure(dev, args.parent)
    for r in result["rows"]:
        unit = "ms per rep" if r["kernel"] == "overlap" else "ms per launch"
        print(f"[ab] {r['kernel']} {r['input']} {r['build']}: {r['ms']:.5f} {unit} (rounds "
              f"{', '.join(f'{x:.5f}' for x in r['rounds'])}; equal to plain) on {card}",
              flush=True)
    for kernel in ("scaling_body", "scaling_overlap"):
        for b in dict.fromkeys(r["build"] for r in result["rows"]):
            ms = {r["input"]: r["ms"] for r in result["rows"]
                  if r["kernel"] == kernel and r["build"] == b}
            print(f"[scaling] {kernel[8:]} {b}: " + ", ".join(
                f"{s} {ms[s]:.5f} ms ({ms[s] / ms['one']:.3f}x)" for s in SCALES), flush=True)
    print(f"[clock] SM clock under full's load: {result['clock_mhz']} MHz", flush=True)
    sass = sass_report()
    for name, rep in sass.items():
        print(f"[sass] {name}: {rep['ops']}", flush=True)
        for lp in rep["loops"]:
            print(f"[loop] {name} 0x{lp['head']:x}-0x{lp['tail']:x}: {lp['ops']}; hot "
                  f"{lp['hot']}; 2/pi multiplies {lp['trip_iters']}", flush=True)
    this = {(r["kernel"], r["input"]): r["ms"] for r in result["rows"] if r["build"] == THIS}
    if not result["clock_mhz"]:
        print("body_ab: nvidia-smi read no SM clock", file=sys.stderr)
        return 1
    mhz = sorted(result["clock_mhz"])[len(result["clock_mhz"]) // 2]
    bounds = three_bounds(sass, mhz * 1e6, {"probe_body": this[("body", "full")],
                                            "probe_overlap": this[("overlap", "kernel")]})
    for name, b in bounds.items():
        print(f"[bounds] {name}: FP32 {b['bound_ms']:.5f} ms, unfused {b['bound_unfused_ms']:.5f}"
              f" ms, issue {b['bound_issue_ms']:.5f} ms ({b['sass_per_iter']:.2f} warp "
              f"instructions an iteration at {mhz} MHz); measured, {b['issue_reading']:.1f} "
              f"an iteration at the issue rate", flush=True)
    print(json.dumps({"body_ab": result["rows"], "clock_mhz": result["clock_mhz"],
                      "bounds": bounds, "sass": sass, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
