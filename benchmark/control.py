"""The correctness check's control, and the readings its limits come from.

    python3 -m benchmark.control --workload <cell> --seeds <n> [<n> ...] --seconds <s>

For each seed it runs the cell with a short untraced window, then prints
one JSON line: the check's numbers for the program (the lower readings)
and, on the first ``--control-seeds`` seeds, for the control, the
reference computed in bfloat16 standing in for the program (the upper
readings), and with ``--faults`` (fit cells) for the reference carrying
each named fault (``drivers/fit.py`` ``FAULTS``). The configurations state float32 with
TF32 off, but no path here multiplies matrices, so TF32 would change
nothing; bfloat16 is the next lower precision the arithmetic can take.
The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import math

import torch

from benchmark import run


def readings(cell, seed: int, seconds: float, devices, faults=(), control=True) -> dict:
    """The program's numbers, the control's, and those of each of the
    fit driver's ``faults`` planted in the reference standing in, on the
    cell's ``devices`` (``run.hand``)."""
    run.hand(cell, seed, seconds, False, devices)
    res = run.driver(cell.traffic["kind"]).run(cell)
    finite = lambda d: {k: v if math.isfinite(v) else None for k, v in d.items()}
    out = dict(seed=seed, attempted=res["attempted"], program=finite(res["check"]()))
    if not control:
        return out
    out["control"] = finite(res["check"](torch.bfloat16))
    for f in faults:
        out[f] = finite(res["check"](f))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--faults", nargs="*", default=[],
                    help="fit cells: faults to plant in the reference standing in")
    ap.add_argument("--control-seeds", type=int, default=None,
                    help="read the control and the faults on this many of the seeds, the first")
    args = ap.parse_args(argv)
    devices = run.cuda_cards(run.load_cell(run.ROOT, args.workload).entry["chips"])
    if devices is None:
        return 3
    n_control = len(args.seeds) if args.control_seeds is None else args.control_seeds
    for i, seed in enumerate(args.seeds):
        cell = run.load_cell(run.ROOT, args.workload)
        print(json.dumps(readings(cell, seed, args.seconds, devices, args.faults, i < n_control)),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
