"""How do the flash chunk-body and block-cull probe kernels compare with
another checkout's on the same inputs?

The port's own measurement beside two probes (``flash3_probe``,
``flash2_probe``'s block cull). It builds ``csrc/probe_flash_body.cu`` and
``csrc/probe_flash_cull.cu`` of this checkout and, with ``--parent DIR``
(repeatable), the two sources of the checkout at ``DIR`` as they are, and
times each build on the probes' own inputs:

- ``body``: the chunk body's layouts ``base``, ``r8`` and, where the build
  has it, ``tile``, at 32,768 rays (``<mode>_32k``) and at the tool's 512,
  50 chunks of 128 random triangles, 8 reps (``flash3_probe.make_inputs``);
- ``cull``: the block cull on 65,536 teapot rays of each of
  ``flash2_probe.CULL_RAY_SETS`` (``into``: every block reaches every
  chunk; ``away``: none; ``camera``: some);
- ``flash1``: this checkout's per-ray cull flash kernel
  (``ops/flash_intersect.flash_intersect_triangles``) on the same rays, the
  block cull's yardstick.

Every build's outputs must equal the plain version's, bit for bit (t and
visits for the cull). Each launch is timed as a CUDA graph of launches,
replayed between CUDA events, once with the builds in the order given
(the parents, then this checkout) and once in reverse (parent, this, this,
parent); each time is the mean of the two. Last, ``cuobjdump -sass``
counts the instructions of this build's ``tile`` and cull kernels (the
cull's instantiation for at most 4,096 chunks) by opcode; neither may
hold an ``FCHK``, the range check of a general division (the test's
``1.0f / det`` must compile to a reciprocal).

    python -m zraytrace_tpu_torch.probes.flash_ab [--parent DIR ...]

Needs a CUDA device. Prints ``[ptxas]`` lines, ``[visits]`` per ray set,
one ``[ab]`` line per input, kernel and build, ``[sass]`` lines and one
JSON line; exits 1 where a kernel holds an ``FCHK``.
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

from zraytrace_tpu_torch.ops import flash_intersect as fi
from zraytrace_tpu_torch.ops.build import build, find_nvcc, load
from zraytrace_tpu_torch.probes import flash2_probe, flash3_probe
from zraytrace_tpu_torch.probes.common import (THIS, ab_rounds, build_checkouts, card_line,
                                               time_graph_calls)

SOURCES = ("probe_flash_body", "probe_flash_cull")
BODY_SHAPES = {f"{m}{s}": (m, n) for s, n in (("_32k", flash3_probe.R_FULL),
                                               ("", flash3_probe.R))
               for m in ("base", "r8", "tile")}
BODY_REPLAYS = 3  # graph replays of a launch of milliseconds
CULL_REPLAYS = 20
SASS_OPS = ("MUFU.RCP", "FCHK", "FFMA", "FMUL", "FADD", "FSETP", "FSEL", "FMNMX", "LDS",
            "LDGSTS", "CALL")

_I, _P = ctypes.c_int, ctypes.c_void_p


class Build:
    """The two probe kernels of one build, launched by ctypes on outputs
    allocated once per input (so a CUDA graph holds only the kernels)."""

    def __init__(self, name: str, csrc: Path):
        self.name = name
        self.body = load("probe_flash_body", csrc)
        self.body.zr_probe_flash_body_launch.argtypes = [_I, _P, _I, _P, _P, _P, _I, _I, _P]
        self.body.zr_probe_flash_body_launch.restype = _I
        self.cull = load("probe_flash_cull", csrc)
        self.cull.zr_probe_flash_cull_launch.argtypes = [_P, _P, _I, _P, _P, _P, _P, _I, _P]
        self.cull.zr_probe_flash_cull_launch.restype = _I
        # a launch of no rays returns at once where the build knows the mode
        # and refuses a mode index it does not know
        self.has_tile = self.body.zr_probe_flash_body_launch(
            flash3_probe.MODES.index("tile"), None, 0, None, None, None, 0, 0, None) == 0

    def body_call(self, mode: str, planes, o, d):
        out = torch.empty((o.shape[0],), device=o.device)

        def launch():  # holds out, whose memory the kernel writes
            err = self.body.zr_probe_flash_body_launch(
                flash3_probe.MODES.index(mode), planes.data_ptr(), planes.shape[1],
                o.data_ptr(), d.data_ptr(), out.data_ptr(), o.shape[0], flash3_probe.REPS,
                torch.cuda.current_stream(o.device).cuda_stream)
            if err:
                raise RuntimeError(f"{self.name}: flash body launch failed ({err})")
        return launch, (out,)

    def cull_call(self, planes, bounds, o, d):
        n = o.shape[0]
        out = (torch.empty((n,), device=o.device),
               torch.empty((n // flash2_probe.RB,), dtype=torch.int32, device=o.device))

        def launch():  # holds out, whose memory the kernel writes
            err = self.cull.zr_probe_flash_cull_launch(
                planes.data_ptr(), bounds.data_ptr(), planes.shape[1], o.data_ptr(),
                d.data_ptr(), out[0].data_ptr(), out[1].data_ptr(), n,
                torch.cuda.current_stream(o.device).cuda_stream)
            if err:
                raise RuntimeError(f"{self.name}: cull launch failed ({err})")
        return launch, out


def sass_counts(source: str, kernel: str) -> dict:
    """Instructions of ``kernel`` in this checkout's build of ``source``, by
    opcode (``SASS_OPS``) and in all, from ``cuobjdump -sass``."""
    tool = shutil.which("cuobjdump") or str(Path(find_nvcc()).with_name("cuobjdump"))
    text = subprocess.run([tool, "-sass", str(build(source)["path"])], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    counts, inside = collections.Counter(), False
    for line in text.splitlines():
        if "Function :" in line:
            inside = kernel in line
        elif inside and re.search(r"/\*[0-9a-f]{4}\*/", line):
            op = re.sub(r"^\s*/\*[0-9a-f]+\*/\s*(@!?U?P\w+\s+)?", "", line).split()[0]
            counts["all"] += 1
            for name in SASS_OPS:
                if op.startswith(name):
                    counts[name] += 1
    return dict(counts)


def _check(tag: str, got, want) -> None:
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise RuntimeError(f"{tag}: differs from the plain version")


def measure(dev, parents=()) -> list[dict]:
    """One row per input, kernel and build (``{"input", "kernel", "build",
    "ms", "rounds"}``); raises where a build's outputs differ from the
    plain version's."""
    all_builds = [Build(name, csrc) for name, csrc in build_checkouts(SOURCES, parents).items()]
    cases = []  # (input, kernel, {build name: launch}, replays)
    inputs = {}
    for shape, (mode, rays) in BODY_SHAPES.items():
        if rays not in inputs:
            planes, o, d = flash3_probe.make_inputs(dev, rays)
            inputs[rays] = (planes, o, d, flash3_probe.flash_body_plain(planes, o, d))
        planes, o, d, want = inputs[rays]
        calls = {}
        for b in all_builds:
            if mode == "tile" and not b.has_tile:
                continue
            launch, out = b.body_call(mode, planes, o, d)
            launch()
            _check(f"{shape} {b.name}", out, (want,))
            calls[b.name] = launch
        cases.append((shape, "body", calls, BODY_REPLAYS))
    tp = flash2_probe.cull_planes(dev)
    for which, (o, d) in flash2_probe.cull_rays(dev).items():
        want = flash2_probe.flash_cull_plain(tp.planes, tp.bounds, o, d)
        calls = {}
        for b in all_builds:
            launch, out = b.cull_call(tp.planes, tp.bounds, o, d)
            launch()
            _check(f"cull {which} {b.name}", out, want)
            calls[b.name] = launch
        cases.append((which, "cull", calls, CULL_REPLAYS))
        _check(f"flash1 {which}", (fi.flash_intersect_triangles(tp, o, d, 1e-3)[0],), want[:1])
        cases.append((which, "flash1", {THIS: lambda o=o, d=d: fi.flash_intersect_triangles(
            tp, o, d, 1e-3)}, CULL_REPLAYS))
        print(f"[visits] {which}: {int(want[1].sum())} chunk visits over {want[1].numel()} "
              f"blocks, {int((want[0] < 1e38).sum())} rays hit", flush=True)
    rows = []
    for name, kernel, calls, replays in cases:
        times = ab_rounds({b: lambda f=f, r=replays: time_graph_calls([f], dev, r)
                           for b, f in calls.items()})
        rows += [dict(input=name, kernel=kernel, build=b, ms=sum(ms) / len(ms), rounds=ms)
                 for b, ms in times.items()]
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, action="append", default=[],
                    help="root of another checkout to time beside (repeatable)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("flash_ab: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"gpu: {card}", flush=True)
    rows = measure(dev, args.parent)
    for r in rows:
        print(f"[ab] {r['kernel']} {r['input']} {r['build']}: {r['ms']:.5f} ms per launch "
              f"(rounds {', '.join(f'{x:.5f}' for x in r['rounds'])}; equal to plain) on "
              f"{card}", flush=True)
    sass = {}
    for source, kernel in (("probe_flash_body", "flash_body_tile"),
                           ("probe_flash_cull", "cull_kernelILb0E")):
        sass[kernel] = sass_counts(source, kernel)
        print(f"[sass] {kernel}: {sass[kernel]}", flush=True)
    print(json.dumps({"flash_ab": rows, "sass": sass, "card": card}))
    divisions = [k for k, c in sass.items() if c.get("FCHK")]
    if divisions:
        print(f"flash_ab: a general division (FCHK) in {divisions}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
