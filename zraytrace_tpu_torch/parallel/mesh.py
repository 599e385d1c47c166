"""Renders split over the ranks of a process group.

Counterpart of ``zraytrace_tpu/parallel/mesh.py``. The ranks form a
``("data", "sample")`` mesh: pixels are split over ``data``, the sample
range over ``sample``. The sample mean is a sum, so partial slot sums add
over ``sample``. Scene and camera are replicated: every rank holds its
own copy. Collectives are ``torch.distributed``'s (NCCL between cards,
gloo between ranks that share one).

The lane map (``rank_lanes``): ``render()``'s lanes are cut into chunks
of 32, one warp each, dealt round-robin over ``data``: rank *d* owns
chunks *d*, *d* + n_data, ... So each of its warps is one of ``render()``'s
warps (the same pixels side by side), every rank gets every part of the
image, and the ranks' work evens out. Padding lanes (when the chunks do
not divide over ``data``) take the pixel id ``n_pixels`` and idle from
the start, so counters are exact. A rank traces its lanes with the same
pixel stride, through the same route (``render.mesh_routing``: on the
card the bounce kernel, in mesh mode for mesh scenes, or for a mesh with
image-textured materials the wavefront with the flash kernel), with its
samples cut into ``min(n_data, spp)`` contiguous blocks
(``render.sample_blocks``), each block on lanes of its own: a rank's one
launch has as many lanes as ``render()``'s (counter ``mesh.lanes``). A
pixel's sum is its block sums added in block order, so the image equals,
bit for bit, the in-order sum of ``render.trace_lanes`` over the blocks'
ranges (over ``sample`` shards, their sum after that), and differs from
``render()``'s one running sum by the order of the adds; event counters
equal ``render()``'s, and ``wavefront_iterations`` is the longest lane's
steps over one block. On a one-rank mesh the image is ``render()``'s bit
for bit.

The image is assembled with one all-reduce: each rank writes its slot
sums into its lanes of a zeroed buffer of all lanes (a strided view), so
over ``data`` one nonzero term meets zeros (exact), and over ``sample``
the partial sums add. All-reduce is the one collective gloo runs on CUDA
tensors besides broadcast.

Rank *r* of a host computes on its own card: ``make_mesh()`` takes
``cuda:<LOCAL_RANK>`` (``torchrun`` sets it, as does
``multihost.run_ranks``). NCCL itself refuses two ranks on one card, at
the first collective.

Spans (``profiling``): ``mesh.render``, one image on one rank, with
``mesh.prepare`` (scene and camera to the card, routing, lane ids),
``mesh.trace`` (this rank's launch, to its synchronise), ``mesh.allreduce``
(the three all-reduces, to the counters on the host), ``mesh.fetch`` and
``mesh.divide``. Counters: ``collective.all_reduce`` (calls),
``collective.bytes`` (the bytes this rank hands to them),
``mesh.rank_rays`` (this rank's own rays, before the sum) and
``mesh.lanes`` (the lanes of this rank's launch: its pixel lanes times
its sample blocks).

The TPU engine's lane map balancing, tile-coherent fallback, sample
interleave and lane granularity are its machinery and have no
counterpart: the kernel takes any lane count.
"""

from __future__ import annotations

import math
import os

import torch
import torch.distributed as dist

from zraytrace_tpu_torch import camera as cam
from zraytrace_tpu_torch.config import RenderParams
from zraytrace_tpu_torch.profiling import count, span
from zraytrace_tpu_torch.render import C_ITERS, RenderStats
from zraytrace_tpu_torch.scene import Scene

__all__ = ["DATA_AXIS", "SAMPLE_AXIS", "Mesh", "make_mesh", "render_sharded", "sharded_sums",
           "check_replicated", "rank_lanes"]

DATA_AXIS = "data"
SAMPLE_AXIS = "sample"
WARP = 32  # the lane map's chunk: one warp of render()'s lanes


class Mesh:
    """A ``("data", "sample")`` ``DeviceMesh`` over the group's ranks and
    this rank's compute device. Rank ``r`` sits at ``(r // n_sample, r %
    n_sample)``."""

    def __init__(self, device_mesh, device: torch.device):
        self.device_mesh = device_mesh
        self.device = device
        sizes = tuple(device_mesh.mesh.shape)
        self.shape = {DATA_AXIS: sizes[0], SAMPLE_AXIS: sizes[1]}
        rank = dist.get_rank()
        self.coords = (rank // sizes[1], rank % sizes[1])

    def group(self, axis: str | None = None):
        """The process group of ``axis`` through this rank, or of all
        ranks of the mesh (None)."""
        return dist.group.WORLD if axis is None else self.device_mesh.get_group(axis)


def make_mesh(n_data: int | None = None, n_sample: int = 1, device="cuda") -> Mesh:
    """The mesh over every rank of the process group (``multihost.initialize``
    first), all ranks on ``data`` by default. ``device``: this rank's
    compute device; ``"cuda"`` (the default) is ``cuda:<LOCAL_RANK>``
    where the environment sets it (``torchrun``, ``multihost.run_ranks``),
    else the current card; an indexed card may be shared by gloo ranks.
    Collective: every rank calls it."""
    from torch.distributed.device_mesh import DeviceMesh

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_mesh(device='cuda') but no CUDA device is available")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "parallel.multihost.initialize(...) first")
    world = dist.get_world_size()
    if n_data is None:
        n_data = world // n_sample
    if n_data * n_sample != world:
        raise ValueError(f"{world} ranks cannot form a {n_data}x{n_sample} mesh")
    if device.type == "cuda":
        if device.index is None:
            local = os.environ.get("LOCAL_RANK")
            device = torch.device("cuda", torch.cuda.current_device() if local is None
                                  else int(local))
        # before the DeviceMesh, which would otherwise pick a card from the rank
        torch.cuda.set_device(device)
    ranks = torch.arange(world, dtype=torch.int32).reshape(n_data, n_sample)
    dm = DeviceMesh(device.type, ranks, mesh_dim_names=(DATA_AXIS, SAMPLE_AXIS))
    return Mesh(dm, device)


def _checksum(tensors) -> torch.Tensor:
    """An exact integer checksum of tensors' bits, on their device:
    position-weighted sums of the 32-bit words."""
    out = []
    for t in tensors:
        flat = t.detach().reshape(-1).contiguous()
        if flat.element_size() % 4:
            flat = flat.to(torch.int32)
        words = flat.view(torch.int32).to(torch.int64)
        weight = torch.arange(words.numel(), device=words.device) % 1021 + 1
        out.append((words * weight).sum())
    return torch.stack(out)


def check_replicated(tensors, what: str, group=None) -> None:
    """Raise unless every rank holds the same bits in ``tensors`` (their
    checksums' minimum and maximum over the ranks agree)."""
    s = _checksum(tensors)
    lo, hi = s.clone(), s.clone()
    dist.all_reduce(lo, dist.ReduceOp.MIN, group=group)
    dist.all_reduce(hi, dist.ReduceOp.MAX, group=group)
    if not torch.equal(lo, hi):
        raise RuntimeError(f"the ranks hold different {what}")


def rank_lanes(n_lanes: int, n_data: int, d: int, n_pixels: int, device) -> torch.Tensor:
    """Rank ``d``'s lanes of ``render()``'s ``n_lanes`` (lane i starting
    at pixel i): the chunks of ``WARP`` lanes ``d``, ``d + n_data``, ...,
    padded to ``ceil(chunks / n_data)`` chunks with the id ``n_pixels``
    (no pixel). Every rank gets as many, so chunk ``c`` of rank ``d`` is
    chunk ``c * n_data + d`` of the buffer of all lanes."""
    chunks = -(-n_lanes // WARP)
    ids = ((torch.arange(-(-chunks // n_data), dtype=torch.int32, device=device) * n_data
            + d)[:, None] * WARP
           + torch.arange(WARP, dtype=torch.int32, device=device)).reshape(-1)
    ids[ids >= n_lanes] = n_pixels
    return ids


def sharded_sums(scene: Scene, camera: cam.Camera, params: RenderParams, mesh: Mesh,
                 sample_start: int = 0):
    """The collective body of ``render_sharded``: returns ``(pixel sums
    (H*W, 3) f32 CPU tensor over samples [sample_start, sample_start +
    spp), counters list of ints, seconds)``, the seconds a dict of
    ``setup``, ``trace`` (this rank's launch, to its end), ``collective``
    (the all-reduces, to the counters on the host) and ``fetch``: the
    spans ``mesh.prepare``, ``.trace``, ``.allreduce`` and ``.fetch``.
    Event counters sum over the ranks; ``wavefront_iterations`` is the
    largest rank's, as in ``render()`` the longest lane's. The rank's
    lanes are ``rank_lanes``' over ``min(n_data, spp)`` sample blocks
    (module docstring)."""
    from zraytrace_tpu_torch.ops.bounce_kernel import library
    from zraytrace_tpu_torch.render import mesh_routing, sample_blocks, trace_route

    n_data, n_sample = mesh.shape[DATA_AXIS], mesh.shape[SAMPLE_AXIS]
    w, h, spp = params.width, params.height, params.samples_per_pixel
    if spp % n_sample:
        raise ValueError(f"spp={spp} must divide over sample axis {n_sample}")
    dev = mesh.device
    spp_local = spp // n_sample
    n_pixels = w * h
    n_lanes = min(n_pixels, params.max_wavefront)
    n_slots = math.ceil(n_pixels / n_lanes)
    d, s = mesh.coords
    with span("mesh.prepare") as prepare:
        if dev.type == "cuda":
            library()
        scene = scene.to(dev)
        camera = camera.to(dev)
        route = mesh_routing(scene, dev)
        if route.tri_flash is not None:
            check_replicated([x for x in route.tri_flash if isinstance(x, torch.Tensor)],
                             "flash planes")
        base = rank_lanes(n_lanes, n_data, d, n_pixels, dev)
        per = base.shape[0]

    with span("mesh.trace") as trace:
        sums, counters = trace_route(
            route, scene, camera, base, params.seed, w, h, spp_local, params.max_depth,
            sample_start + s * spp_local, n_lanes, n_pixels, n_slots, blocks=n_data)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        count("mesh.lanes", len(sample_blocks(spp_local, n_data)) * per)
    with span("mesh.allreduce") as collective:
        full = torch.zeros((n_slots, per * n_data, 3), dtype=torch.float32, device=dev)
        full.view(n_slots, per // WARP, n_data, WARP, 3)[:, :, d] = sums.view(
            n_slots, per // WARP, WARP, 3)
        own_rays = counters[:1].clone()
        events, iters = counters[:C_ITERS].clone(), counters[C_ITERS:].clone()
        dist.all_reduce(full, group=mesh.group())
        dist.all_reduce(events, group=mesh.group())
        dist.all_reduce(iters, dist.ReduceOp.MAX, group=mesh.group())
        count("collective.all_reduce", 3)
        count("collective.bytes", sum(t.numel() * t.element_size() for t in (full, events, iters)))
        *totals, own = torch.cat([events, iters, own_rays]).cpu().tolist()  # waits for the device
        count("mesh.rank_rays", own)
    with span("mesh.fetch") as fetch:
        flat = full[:, :n_lanes].reshape(n_slots * n_lanes, 3)[:n_pixels].cpu()
    return flat, totals, dict(setup=prepare.seconds, trace=trace.seconds,
                              collective=collective.seconds, fetch=fetch.seconds)


def render_sharded(scene: Scene, camera: cam.Camera, params: RenderParams, mesh: Mesh,
                   sample_start: int = 0):
    """Distributed forward render over ``mesh``; every rank of the mesh
    calls it and gets the full ``(image (H, W, 3) f32 CPU tensor,
    RenderStats)``. spp must divide over the sample axis; the sample range
    starts at ``sample_start`` (streams are keyed by the absolute sample
    index, so chunks of a long render resume exactly). One call is the
    span ``mesh.render``."""
    with span("mesh.render"):
        flat, totals, sec = sharded_sums(scene, camera, params, mesh, sample_start)
        with span("mesh.divide") as divide:
            image = (flat / params.samples_per_pixel).reshape(params.height, params.width, 3)
    rays, refl, bg, rec, samples, iters = totals
    return image, RenderStats(
        rays=rays, reflections=refl, background_hits=bg, recursion_depth_hits=rec,
        samples=samples, pixels=params.width * params.height, wavefront_iterations=iters,
        preprocess_seconds=sec["setup"], render_seconds=sec["trace"] + sec["collective"],
        transfer_seconds=sec["fetch"] + divide.seconds)
