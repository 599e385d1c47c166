"""How do the flash and margin kernels compare with another checkout's
kernels on the inputs the main paths give them?

The port's own measurement (no TPU tool stands behind it). It builds the
flash winner (``csrc/flash_intersect.cu``) and the margin selection
(``csrc/flash_margins.cu``) of this checkout and, with ``--parent DIR``
(repeatable), the two sources of the checkout at ``DIR`` as they are, and
times each build, in turns, on the inputs of ``kernel_inputs``:

- ``step``: the 4 launches of each kernel in one teapot pose step
  (``tools/diff_bench.py`` ``teapot_pose_fit``: 64x64, 8 spp, depth 4;
  the 8 samples as 32,768 lanes of each), recorded from ``render_diff``
  and timed as one CUDA graph of the 4, replayed;
- ``flash_scene3``: the flash kernel on scene 3's 490,000 camera rays and
  one bounce of them, seeded with the sphere t, packed ids
  (``chip_smoke.py`` phase 5);
- ``margins_camera`` and ``margins_surface``: the margin kernel on the
  pose-fit scene's 4,096 x 8 camera rays and 4,096 rays leaving the
  teapot's surface (``chip_smoke.py`` phase 9);
- ``floor``: both kernels on 4,096 rays that reach no chunk (the step's
  planes), the cost of a launch and its slab tests without a walk.

Then, for this checkout's build, whether L2 reads could bound it: the
plane bytes each set's tests read (from the counting build's work counts:
16 B of normal and ``a.fn`` per triangle test; for the margins 48 B more
per test past t, for the flash winner 24 B more per test past t and again
per test past u, as its lanes tested them), over its time above the
floor, against the read rate a library reduction (``torch.sum``) gets
from a 24 MB tensor held in the 50 MB L2.

Each build's outputs must equal the plain version's, bit for bit. The
builds run in the order given and then in reverse (A B C, C B A), and each
time is the mean of the two. The margin kernel of a checkout whose entry
takes dilated boxes (``dil_bounds``: before the kernel dilated them
itself) gets them precomputed, and is timed once more with the
dilation's PyTorch operations in the graph, as its wrapper ran them.

    python -m zraytrace_tpu_torch.probes.winner_lanes [--parent DIR ...]

Needs a CUDA device. Prints one line per input set, kernel and build, and
one JSON line.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import json
import sys
from pathlib import Path

import torch

from zraytrace_tpu_torch import kernel_inputs as ki
from zraytrace_tpu_torch.ops import flash_intersect as fi
from zraytrace_tpu_torch.ops.build import CSRC, build, load
from zraytrace_tpu_torch.probes.common import card_line, time_graph_calls

SOURCES = ("flash_intersect", "flash_margins")
THIS = "this"  # the name of this checkout's build
T_MIN = ki.T_MIN

_I, _P, _F = ctypes.c_int, ctypes.c_void_p, ctypes.c_float


def _bind(lib: ctypes.CDLL, symbol: str, argtypes) -> ctypes.CDLL:
    fn = getattr(lib, symbol)
    fn.argtypes, fn.restype = argtypes, _I
    return lib


class Build:
    """Both kernels of one build, launched by ctypes on outputs allocated
    once per input (so a CUDA graph of launches holds only the kernels)."""

    def __init__(self, name: str, flash: ctypes.CDLL, margins: ctypes.CDLL,
                 dilated: bool = False):
        self.name, self.dilated = name, dilated
        self.flash = _bind(flash, "zr_flash_launch",
                           [_P, _P, _I, _I, _P, _P, _P, _F, _I, _P, _P, _P, _P, _P, _P])
        self.margins = _bind(margins, "zr_margins_launch",
                             [_P, _P, _I, _P, _P, _P, _F, _I, _P, _P, _P, _P, _P])

    def flash_call(self, planes, o, d, t_init):
        n, dev = o.shape[0], o.device
        out = (torch.empty((n,), device=dev), torch.empty((n,), dtype=torch.int32, device=dev),
               torch.empty((n,), dtype=torch.bool, device=dev), torch.empty((n, 2), device=dev))

        def launch():  # holds out, whose memory the kernel writes
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = self.flash.zr_flash_launch(
                planes.planes.data_ptr(), planes.bounds.data_ptr(), planes.n_chunks,
                int(planes.attrs is not None), o.data_ptr(), d.data_ptr(),
                None if t_init is None else t_init.data_ptr(), T_MIN, n,
                *[x.data_ptr() for x in out], None, stream)
            if err:
                raise RuntimeError(f"{self.name}: flash launch failed ({err})")
        return launch, out

    def margins_call(self, planes, o, d, t_cap, dilate_in_graph: bool = False):
        n, dev = o.shape[0], o.device
        out = torch.empty((3, n), dtype=torch.int32, device=dev)
        boxes = fi.dilated_bounds(planes.bounds) if self.dilated else planes.bounds

        def launch():  # holds out, whose memory the kernel writes
            b = fi.dilated_bounds(planes.bounds) if dilate_in_graph else boxes
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = self.margins.zr_margins_launch(
                planes.planes.data_ptr(), b.data_ptr(), planes.n_chunks, o.data_ptr(),
                d.data_ptr(), t_cap.data_ptr(), T_MIN, n, out[0].data_ptr(), out[1].data_ptr(),
                out[2].data_ptr(), None, stream)
            if err:
                raise RuntimeError(f"{self.name}: margin launch failed ({err})")
        return launch, tuple(out)


def builds(parents=()) -> list[Build]:
    """This checkout's build, then each checkout in ``parents``, named by
    its directory; compiled in parallel (one nvcc per source and
    checkout)."""
    jobs = {THIS: CSRC}
    for p in parents:
        jobs[Path(p).name] = Path(p).resolve() / "zraytrace_tpu_torch" / "csrc"
    with concurrent.futures.ThreadPoolExecutor(2 * len(jobs)) as pool:
        futures = {(name, src): pool.submit(build, src, csrc)
                   for name, csrc in jobs.items() for src in SOURCES}
        for (name, src), f in futures.items():  # registers and spills per kernel
            usage = [line.strip() for line in f.result()["log"].splitlines()
                     if "registers" in line or "spill" in line]
            print(f"[ptxas] {name} {src}: {' | '.join(usage)}", flush=True)
    return [Build(name, load("flash_intersect", csrc), load("flash_margins", csrc),
                  dilated="dil_bounds" in (csrc / "flash_margins.cu").read_text())
            for name, csrc in jobs.items()]


def measure(dev, parents=()):
    """``(rows, l2)``: one row per input set, kernel and build (``{"set",
    "kernel", "build", "ms", "rounds", "launches", "rays"}``), and
    ``l2_reads`` of the sets; raises where a build's output differs from
    the plain version's."""
    from zraytrace_tpu_torch.diff_trace import pack_for_diff
    from zraytrace_tpu_torch.geometry.bvh import build_tri_bvh
    from zraytrace_tpu_torch.scenes import build_scene, teapot_on_ground

    all_builds = builds(parents)
    step = {k: [(c.planes, c.o, c.d, c.x) for c in v]
            for k, v in ki.pose_step_calls(dev).items()}
    b3 = build_scene(3, dev)
    tris = [x.cpu() for x in (b3.scene.tri_a, b3.scene.tri_b, b3.scene.tri_c)]
    planes3 = fi.pack_tri_planes(*tris, order=build_tri_bvh(*tris).prim_order,
                                 tri_mat=b3.scene.tri_mat.cpu(), const_materials=True).to(dev)
    fit_b = teapot_on_ground(dev)
    fit_planes = pack_for_diff(fit_b.scene)
    cases = [("step", "flash", step["flash_intersect"]),
             ("step", "margins", step["flash_margins"]),
             ("flash_scene3", "flash", [(planes3, *ki.scene3_rays(b3, dev))])]
    cases += [(f"margins_{k}", "margins", [(fit_planes, *v)])
              for k, v in ki.margin_rays(fit_b, dev).items()]
    p0 = step["flash_intersect"][0][0]
    n0 = step["flash_intersect"][0][1].shape[0]
    away = (torch.full((n0, 3), 1000.0, device=dev),
            torch.tensor([[1.0, 0.0, 0.0]], device=dev).expand(n0, 3).contiguous(),
            torch.full((n0,), 3.4e38, device=dev))
    cases += [("floor", "flash", [(p0, *away)]), ("floor", "margins", [(p0, *away)])]
    rows = []
    for set_name, kernel, inputs in cases:
        plain = fi.flash_intersect_plain if kernel == "flash" else fi.flash_margin_select_plain
        wants = [plain(p, o, d, T_MIN, x) if kernel == "flash" else plain(p, o, d, x, T_MIN)
                 for p, o, d, x in inputs]
        timed = [(b, False) for b in all_builds]
        if kernel == "margins":
            timed += [(b, True) for b in all_builds if b.dilated]
        calls = {}
        for b, in_graph in timed:
            made = [b.flash_call(*x) if kernel == "flash" else b.margins_call(*x, in_graph)
                    for x in inputs]
            for (launch, out), want in zip(made, wants):
                launch()
                if not all(torch.equal(g, w) for g, w in zip(out, want)):
                    raise RuntimeError(f"{set_name} {kernel} {b.name}: differs from plain")
            calls[(b.name, in_graph)] = [launch for launch, _ in made]
        times = {k: [] for k in calls}
        reps = 1 if len(inputs) > 1 else 5  # a graph of the step's launches, or of 5 of one
        for keys in (list(calls), list(calls)[::-1]):
            for k in keys:
                times[k].append(time_graph_calls(calls[k] * reps, dev))
        n_rays = sum(x[1].shape[0] for x in inputs)
        for (name, in_graph), ms in times.items():
            rows.append(dict(set=set_name, kernel=kernel,
                             build=name + (" + dilation" if in_graph else ""),
                             ms=sum(ms) / len(ms), rounds=ms, launches=len(inputs),
                             rays=n_rays // len(inputs)))
    return rows, l2_reads(dev, cases)


def l2_reads(dev, cases) -> dict:
    """Per input set: the plane bytes this checkout's tests read per
    launch, from its counting build; and ``"l2_gbps"``, the read rate of
    ``torch.sum`` over a 24 MB tensor held in L2."""
    out = {}
    for set_name, kernel, inputs in cases:
        if kernel == "flash":
            work = torch.zeros((len(fi.FLASH_WORK_FIELDS),), dtype=torch.int64, device=dev)
            for p, o, d, x in inputs:
                fi.flash_intersect_triangles(p, o, d, T_MIN, x, work=work)
            w = dict(zip(fi.FLASH_WORK_FIELDS, work.tolist()))
            nb = 16 * 128 * w["visits"] + 24 * (w["t_warp"] + w["u_warp"])
        else:
            work = torch.zeros((len(fi.MARGIN_WORK_FIELDS),), dtype=torch.int64, device=dev)
            for p, o, d, x in inputs:
                fi.flash_margin_select(p, o, d, x, T_MIN, work=work)
            w = dict(zip(fi.MARGIN_WORK_FIELDS, work.tolist()))
            nb = 16 * 128 * w["visits"] + 48 * w["t"]
        out[(set_name, kernel)] = dict(bytes_per_launch=nb / len(inputs), work=w)
    x = torch.rand((6 << 20,), device=dev)
    ms = time_graph_calls([lambda: x.sum()] * 20, dev)
    out["l2_gbps"] = x.numel() * 4 / ms / 1e6
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, action="append", default=[],
                    help="root of another checkout to time beside (repeatable)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("winner_lanes: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"gpu: {card}", flush=True)
    rows, l2 = measure(dev, args.parent)
    for r in rows:
        print(f"[ab] {r['set']} {r['kernel']} {r['build']}: {r['ms']:.5f} ms per launch "
              f"(rounds {', '.join(f'{x:.5f}' for x in r['rounds'])}; {r['launches']} "
              f"launch(es) of {r['rays']} rays; equal to plain) on {card}", flush=True)
    ms = {(r["set"], r["kernel"]): r["ms"] for r in rows if r["build"] == THIS}
    for key, x in l2.items():
        if key == "l2_gbps" or key[0] == "floor":
            continue
        above = ms[key] - ms[("floor", key[1])]
        rate = f"{x['bytes_per_launch'] / above / 1e6:.1f} GB/s" if above > 0 else "no time"
        print(f"[l2] {key[0]} {key[1]} ({THIS}): {x['bytes_per_launch'] / 1e6:.3f} MB of "
              f"plane reads per launch ({x['work']}), {ms[key]:.5f} ms, {above:.5f} ms above "
              f"the floor: {rate}, against torch.sum's {l2['l2_gbps']:.1f} GB/s from L2, on "
              f"{card}", flush=True)
    print(json.dumps({"winner_lanes": rows, "l2_gbps": l2["l2_gbps"], "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
