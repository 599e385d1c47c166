"""The traced run's profiler pass: what ran on the device, and what the
host was doing while the device idled.

``profiled(fn, n, device)`` runs ``fn`` ``n`` times under
``torch.profiler`` and reduces the trace: the device's busy seconds (the
union of its kernels', copies' and sets' intervals), in all and by the
card's index, the traced window's seconds on the host clock, the device
operations by name, and the idle gaps between them, each named by the
innermost host operation running at its middle.
"""

from __future__ import annotations

import bisect
import time

import torch

TOP = 10
NAME_CHARS = 120


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _events(prof):
    """``(device, host)`` lists of ``(name, start_ns, end_ns)``, the
    device's with the card's index last."""
    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        if e.is_user_annotation():
            continue
        row = (e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            device.append(row + (e.device_index(),))
        elif e.device_type() == torch.autograd.DeviceType.CPU:
            host.append(row)
    return device, host


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _seconds(merged) -> float:
    return sum(e - s for s, e in merged) * 1e-9


def _label(host, starts, t_ns: int) -> str:
    """The innermost host operation running at ``t_ns``."""
    i = bisect.bisect_right(starts, t_ns) - 1
    for j in range(i, max(i - 5000, -1), -1):
        if host[j][2] > t_ns:
            return host[j][0][:NAME_CHARS]
    return "no host operation"


def reduce_trace(device_ev, host_ev, window_s: float) -> dict:
    """The summary of one traced window (``profiled``'s result)."""
    by_name: dict = {}
    for name, s, e, _ in device_ev:
        key = name[:NAME_CHARS]
        sec, cnt = by_name.get(key, (0.0, 0))
        by_name[key] = (sec + (e - s) * 1e-9, cnt + 1)
    busy = _merge([(s, e) for _, s, e, _ in device_ev])
    by_card = {i: _seconds(_merge([(s, e) for _, s, e, j in device_ev if j == i]))
               for i in {row[3] for row in device_ev}}
    gaps = {}
    if busy:
        host = sorted(host_ev, key=lambda r: r[1])
        starts = [r[1] for r in host]
        edges = [(host[0][1] if host else busy[0][0], busy[0][0])]
        edges += [(busy[k][1], busy[k + 1][0]) for k in range(len(busy) - 1)]
        if host:
            edges.append((busy[-1][1], max(r[2] for r in host)))
        spans = sorted((e - s, s) for s, e in edges if e > s)
        # the longest gaps named one by one, the rest in one sum
        for length, s in spans[-2000:]:
            key = _label(host, starts, s + length // 2)
            gaps[key] = gaps.get(key, 0.0) + length * 1e-9
        rest = sum(length for length, _ in spans[:-2000]) * 1e-9
        if rest:
            gaps["shorter gaps"] = gaps.get("shorter gaps", 0.0) + rest
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:TOP]
    return dict(
        busy_s=_seconds(busy), busy_by_card=by_card, window_s=window_s,
        device_ops=len(device_ev), kernels={k: v[0] for k, v in by_name.items()},
        kernel_counts={k: v[1] for k, v in by_name.items()},
        breakdown=dict(device_ops=[[k, v[0]] for k, v in top_ops],
                       idle_gaps=[[k, v] for k, v in sorted(gaps.items(),
                                                            key=lambda kv: -kv[1])[:TOP]]))


def profiled(fn, n: int, device) -> tuple:
    """``fn()`` ``n`` times under the profiler: ``(results, summary)``."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    _sync(device)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        out = [fn() for _ in range(n)]
        _sync(device)
        window_s = time.perf_counter() - t0
    return out, reduce_trace(*_events(prof), window_s)
