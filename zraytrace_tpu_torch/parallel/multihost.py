"""Joining a process group, and starting the ranks of one on this host.

Counterpart of ``zraytrace_tpu/parallel/multihost.py``. Every rank runs
the same program; after ``initialize()`` the mesh of ``parallel.mesh``
spans the group's ranks, and its renders and training steps speak only
in terms of the mesh. Typical flow, on every rank (``torchrun`` sets the
rendezvous and ``LOCAL_RANK`` in the environment, and ``make_mesh()``
puts rank *r* of a host on its card ``cuda:<LOCAL_RANK>``):

    from zraytrace_tpu_torch.parallel import mesh, multihost
    multihost.initialize()
    m = mesh.make_mesh(n_sample=2)
    img, stats = mesh.render_sharded(scene, camera, params, m)
    if multihost.is_coordinator():
        write_png(path, img)

``run_ranks`` starts the ranks of a group on this host in fresh
processes (``spawn``), with ``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE`` set as
``torchrun`` sets them: one rank a card (``device="cuda"``), several ranks
on one card (``device="cuda:0"``, gloo), or on the CPU.
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
import queue
import shutil
import tempfile
import traceback

import torch
import torch.distributed as dist

__all__ = ["initialize", "is_coordinator", "local_device_count", "global_device_count",
           "rank_device", "run_ranks", "RankError"]

_ENV_KEYS = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")


def initialize(**kwargs) -> None:
    """``torch.distributed.init_process_group(**kwargs)``; nothing when
    this process already joined a group. With explicit kwargs a failed
    rendezvous raises. With none, the rendezvous comes from the
    environment (``env://``, as ``torchrun`` sets it), and without one
    the process runs standalone, in no group."""
    if dist.is_initialized():
        return
    if kwargs:
        dist.init_process_group(**kwargs)
    elif all(k in os.environ for k in _ENV_KEYS):
        dist.init_process_group(init_method="env://")


def is_coordinator() -> bool:
    """Rank 0 of the group (a standalone process is its own coordinator)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def local_device_count() -> int:
    """The ranks on this host: ``LOCAL_WORLD_SIZE`` as ``torchrun`` sets
    it, else the group's size (one host), else 1."""
    if "LOCAL_WORLD_SIZE" in os.environ:
        return int(os.environ["LOCAL_WORLD_SIZE"])
    return global_device_count()


def global_device_count() -> int:
    """The ranks of the group, or 1 standalone."""
    return dist.get_world_size() if dist.is_initialized() else 1


class RankError(RuntimeError):
    """A rank started by ``run_ranks`` failed or did not finish in time."""


def rank_device(rank: int, device) -> torch.device | None:
    """The device of local rank ``rank`` when the ranks are started on
    ``device``: the card ``cuda:<rank>`` where ``device`` names the card
    without an index, else ``device`` itself (an indexed card that the
    ranks share, the CPU, or None)."""
    if device is None:
        return None
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", rank)
    return device


def _rank_main(fn, rank, world_size, backend, init_file, device, timeout_s, args, results):
    # ranks on one host talk over the loopback interface
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    os.environ["LOCAL_RANK"] = str(rank)
    os.environ["LOCAL_WORLD_SIZE"] = str(world_size)
    try:
        dev = rank_device(rank, device)
        if dev is not None and dev.type == "cuda":
            torch.cuda.set_device(dev)
        initialize(backend=backend, init_method=f"file://{init_file}", world_size=world_size,
                   rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
        try:
            out = fn(rank, world_size, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise


def run_ranks(fn, world_size: int, *args, backend: str = "gloo", device=None,
              timeout: float = 300.0) -> list:
    """Run ``fn(rank, world_size, *args)`` in ``world_size`` fresh
    processes (``spawn``) that form one process group of ``backend``,
    meeting through a file in a temporary directory. Rank ``r`` gets
    ``LOCAL_RANK=r`` and ``LOCAL_WORLD_SIZE=world_size``; where ``device``
    names a card, ``rank_device(r, device)`` becomes its current device:
    ``"cuda"`` puts rank ``r`` on ``cuda:<r>`` (raises where this host has
    fewer cards than ranks), ``"cuda:0"`` puts every rank there. ``fn``
    must be a module-level function, and its result picklable. Returns the
    results by rank. Every process is joined within ``timeout`` seconds or
    killed; a rank that raised or hung raises ``RankError``."""
    last = rank_device(world_size - 1, device)
    if last is not None and last.type == "cuda" and last.index >= torch.cuda.device_count():
        raise RuntimeError(f"{world_size} ranks on {device!s} need cuda:0 to "
                           f"cuda:{world_size - 1}; this host has {torch.cuda.device_count()} "
                           f"CUDA device(s)")
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="zr_ranks_")
    init_file = os.path.join(tmp, "rendezvous")
    procs = [ctx.Process(target=_rank_main, daemon=True, args=(
        fn, r, world_size, backend, init_file, None if device is None else str(device),
        timeout, args, results)) for r in range(world_size)]
    deadline = datetime.datetime.now() + datetime.timedelta(seconds=timeout)
    out, failures, started = {}, [], []
    try:
        for p in procs:
            p.start()
            started.append(p)
        while len(out) + len(failures) < world_size:
            left = (deadline - datetime.datetime.now()).total_seconds()
            try:
                rank, ok, value = results.get(timeout=max(left, 0.1))
            except queue.Empty:
                break
            if ok:
                out[rank] = value
            else:
                failures.append(f"rank {rank}:\n{value}")
            if failures:
                break  # the others may wait forever on the failed rank
    finally:
        for p in started:
            p.join(timeout=max((deadline - datetime.datetime.now()).total_seconds(), 1.0)
                   if not failures else 5.0)
        for p in started:
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(tmp, ignore_errors=True)
    if failures:
        raise RankError("\n".join(failures))
    if len(out) < world_size:
        missing = sorted(set(range(world_size)) - set(out))
        raise RankError(f"ranks {missing} of {world_size} did not finish in {timeout} s")
    return [out[r] for r in range(world_size)]
