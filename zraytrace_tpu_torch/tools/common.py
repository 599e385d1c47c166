"""What the report tools and examples share: the device an entry point
runs on, the card's name and power limit beside every number, and a wall
clock that waits for the card."""

from __future__ import annotations

import time

import torch

__all__ = ["pick_device", "card_info", "sync", "wall"]


def pick_device(cpu: bool) -> torch.device:
    """The card, or the host with ``cpu``; without a card and without
    ``cpu`` it raises (an entry point never falls back to the CPU)."""
    if cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("this tool runs on a CUDA device; pass --cpu to run it on the host")
    return torch.device("cuda", 0)


def card_info(device: torch.device) -> dict:
    """``{"device": name, "power_limit": watts as nvidia-smi reports
    them}`` of the card, or ``{"device": "cpu", "power_limit": None}``."""
    if device.type != "cuda":
        return dict(device="cpu", power_limit=None)
    from zraytrace_tpu_torch.probes.common import card_line

    name, _, limit = card_line().partition(",")
    return dict(device=name.strip(), power_limit=limit.strip() or None)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def wall(fn, device: torch.device):
    """``(fn(), seconds)`` on the host clock, the card synchronised
    before and after."""
    sync(device)
    t0 = time.perf_counter()
    out = fn()
    sync(device)
    return out, time.perf_counter() - t0
