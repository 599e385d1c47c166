"""The cards a run used, from evidence: one record per card, and the
result line's ``device`` block built from the records.

A record (``record``) is taken in the process that used the card: its
CUDA index there, its UUID, its name, the bytes that process allocated on
it at the most, and, in a traced run, the card's busy seconds in that
process's traced window and the window's seconds. A card counts as used
when its peak bytes are above 0; the UUID tells cards apart across
processes, whatever their indices.
"""

from __future__ import annotations

import os
import re
import statistics
import subprocess
from pathlib import Path

import torch


class WrongCards(Exception):
    """The run used fewer distinct cards than its cell asks for, a card
    twice, or cards of different kinds."""


def smi(field: str, card: str):
    """``nvidia-smi``'s ``field`` of the card ``card`` (a UUID or a PCI
    address), or None where it gives none."""
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={field}", "--format=csv,noheader",
                              "-i", card], capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip() if out.returncode == 0 else None


def uuid(props) -> str:
    """The card's UUID as ``nvidia-smi`` writes it (``GPU-`` and 8-4-4-4-12
    hex digits): PyTorch's, or where its properties lack one,
    ``nvidia-smi``'s for the card's PCI address."""
    u = getattr(props, "uuid", None)
    if u is None:
        return smi("uuid", f"{props.pci_domain_id:08X}:{props.pci_bus_id:02X}:"
                           f"{props.pci_device_id:02X}.0")
    u = str(u)
    return u if u.startswith(("GPU-", "MIG-")) else "GPU-" + u


def record(device, profile: dict | None = None) -> dict:
    """The record of the CUDA ``device`` as this process used it; with a
    traced pass's ``profile`` (``devtrace.profiled``), the card's busy
    seconds in it and its window's seconds."""
    i = torch.device(device).index
    i = torch.cuda.current_device() if i is None else i
    props = torch.cuda.get_device_properties(i)
    rec = dict(index=i, uuid=uuid(props), name=props.name,
               peak_bytes=torch.cuda.max_memory_allocated(i))
    if profile is not None:
        rec.update(busy_s=profile["busy_by_card"].get(i, 0.0), window_s=profile["window_s"])
    return rec


def host_cpu() -> dict:
    """The host's CPU as ``/proc/cpuinfo`` gives it: the first CPU's model
    name and its vendor, family, model and stepping numbers (where a
    virtual machine hides the name, the numbers still tell the part), the
    mean clock over the host's CPUs now, and the CPUs this process may
    run on."""
    try:
        text = Path("/proc/cpuinfo").read_text()
    except OSError:
        text = ""
    first = dict(re.findall(r"^([^:\n]*\S)\s*:[ \t]*(.*)$", text.split("\n\n")[0], re.M))
    mhz = [float(x) for x in re.findall(r"^cpu MHz\s*:\s*([0-9.]+)$", text, re.M)]
    ids = [first.get(k) for k in ("vendor_id", "cpu family", "model", "stepping")]
    return dict(model=first.get("model name"), cpuid=" ".join(ids) if all(ids) else None,
                mhz=statistics.fmean(mhz) if mhz else None, cpus=len(os.sched_getaffinity(0)))


def _named(records) -> str:
    return ", ".join(f"cuda:{r['index']} {r['uuid']}" for r in records) or "none"


def block(records: list, handed: list, chips: int, trace: bool) -> dict:
    """The result line's ``device`` block from the used cards' records, in
    card order: ``count`` the distinct UUIDs, ``kind`` their name,
    ``power_limit`` asked of each by UUID (a string for one card, a list
    for several), ``memory_peak_bytes`` the fullest card's peak; in a
    traced run ``busy_s`` and ``window_s`` the sums over the cards (one
    window times their count, where they share it), so the idle share is
    over all the card time the cell buys. Lists per card go beside.
    Raises ``WrongCards`` where the used cards number fewer than
    ``chips``, one is used twice, or their names differ; ``handed`` (the
    handed cards' records) names what the run was given."""
    used = sorted((r for r in records if r["peak_bytes"] > 0), key=lambda r: r["index"])
    uuids = [r["uuid"] for r in used]
    names = sorted({r["name"] for r in used})
    if len(set(uuids)) < chips or len(set(uuids)) < len(uuids) or len(names) > 1:
        raise WrongCards(
            f"the cell asks for {chips} card(s); handed {_named(handed)}; used {_named(used)}"
            + (f"; of kinds {names}" if len(names) > 1 else ""))
    limits = [smi("power.limit", u) for u in uuids]
    peaks = [r["peak_bytes"] for r in used]
    out = dict(platform="gpu", kind=names[0], count=len(uuids),
               power_limit=limits[0] if len(limits) == 1 else limits,
               memory_peak_bytes=max(peaks), memory_peak_bytes_per_card=peaks,
               cards=[[r["index"], r["uuid"]] for r in used], host_cpu=host_cpu())
    if trace:
        busy, window = [r["busy_s"] for r in used], [r["window_s"] for r in used]
        out.update(busy_s=sum(busy), window_s=sum(window),
                   busy_s_per_card=busy, window_s_per_card=window)
    return out
