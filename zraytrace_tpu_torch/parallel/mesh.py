"""Renders split over the ranks of a process group.

Counterpart of ``zraytrace_tpu/parallel/mesh.py``. The ranks form a
``("data", "sample")`` mesh: pixels are split over ``data``, the sample
range over ``sample``. The sample mean is a sum, so partial slot sums add
over ``sample``. Scene and camera are replicated: every rank holds its
own copy. Collectives are ``torch.distributed``'s (NCCL between cards,
gloo between ranks that share one).

Each rank traces a contiguous slice of ``render()``'s lanes with the same
pixel stride, through the same ``bounce_trace`` (on the card the bounce
kernel, in mesh mode for mesh scenes), so a lane traces the pixels it
would trace in ``render()``, in the same order: with one sample shard the
image equals ``render()``'s bit for bit. Padding lanes (when the lanes do
not divide over ``data``) idle from the start, so counters are exact.

The image is assembled with one all-reduce: each rank adds its slot sums
into its slice of a zeroed buffer of all lanes, so over ``data`` one
nonzero term meets zeros (exact), and over ``sample`` the partial sums
add. All-reduce is the one collective gloo runs on CUDA tensors besides
broadcast.

The TPU engine's lane map balancing, tile-coherent fallback, sample
interleave and lane granularity are its machinery and have no
counterpart: the kernel takes any lane count.
"""

from __future__ import annotations

import math
import time

import torch
import torch.distributed as dist

from zraytrace_tpu_torch import camera as cam
from zraytrace_tpu_torch.config import RenderParams
from zraytrace_tpu_torch.render import C_ITERS, RenderStats
from zraytrace_tpu_torch.scene import Scene

__all__ = ["DATA_AXIS", "SAMPLE_AXIS", "Mesh", "make_mesh", "render_sharded", "sharded_sums",
           "check_replicated"]

DATA_AXIS = "data"
SAMPLE_AXIS = "sample"


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
    compute device (the card by default; a rank may share it with
    others). Collective: every rank calls it."""
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
            device = torch.device("cuda", torch.cuda.current_device())
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


def sharded_sums(scene: Scene, camera: cam.Camera, params: RenderParams, mesh: Mesh,
                 sample_start: int = 0):
    """The collective body of ``render_sharded``: returns ``(pixel sums
    (H*W, 3) f32 CPU tensor over samples [sample_start, sample_start +
    spp), counters list of ints, seconds)``, the seconds a dict of
    ``setup``, ``trace`` (this rank's launch, to its end), ``collective``
    (the all-reduces, to the counters on the host) and ``fetch``.
    Event counters sum over the ranks; ``wavefront_iterations`` is the
    largest rank's, as in ``render()`` the longest lane's."""
    from zraytrace_tpu_torch.ops.bounce_kernel import bounce_trace, library
    from zraytrace_tpu_torch.render import mesh_routing

    n_data, n_sample = mesh.shape[DATA_AXIS], mesh.shape[SAMPLE_AXIS]
    w, h, spp = params.width, params.height, params.samples_per_pixel
    if spp % n_sample:
        raise ValueError(f"spp={spp} must divide over sample axis {n_sample}")
    dev = mesh.device
    t0 = time.perf_counter()
    if dev.type == "cuda":
        library()
    spp_local = spp // n_sample
    n_pixels = w * h
    n_lanes = min(n_pixels, params.max_wavefront)
    n_slots = math.ceil(n_pixels / n_lanes)
    per = -(-n_lanes // n_data)
    d, s = mesh.coords
    scene = scene.to(dev)
    camera = camera.to(dev)
    tri_flash = mesh_routing(scene, dev)
    if tri_flash is not None:
        check_replicated([x for x in tri_flash if isinstance(x, torch.Tensor)],
                         "flash planes")
    base = torch.arange(d * per, (d + 1) * per, dtype=torch.int32, device=dev)
    base[base >= n_lanes] = n_pixels  # padding lanes: no pixel, idle from the start

    t1 = time.perf_counter()
    sums, counters = bounce_trace(
        scene, camera, base, params.seed, w, h, spp_local, params.max_depth,
        sample_start + s * spp_local, n_lanes, n_pixels, n_slots, tri_flash=tri_flash)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t2 = time.perf_counter()
    full = torch.zeros((n_slots, per * n_data, 3), dtype=torch.float32, device=dev)
    full[:, d * per:(d + 1) * per] = sums
    dist.all_reduce(full, group=mesh.group())
    events, iters = counters[:C_ITERS].clone(), counters[C_ITERS:].clone()
    dist.all_reduce(events, group=mesh.group())
    dist.all_reduce(iters, dist.ReduceOp.MAX, group=mesh.group())
    totals = events.cpu().tolist() + iters.cpu().tolist()  # waits for the device
    t_dev = time.perf_counter()
    flat = full[:, :n_lanes].reshape(n_slots * n_lanes, 3)[:n_pixels].cpu()
    return flat, totals, dict(setup=t1 - t0, trace=t2 - t1, collective=t_dev - t2,
                              fetch=time.perf_counter() - t_dev)


def render_sharded(scene: Scene, camera: cam.Camera, params: RenderParams, mesh: Mesh,
                   sample_start: int = 0):
    """Distributed forward render over ``mesh``; every rank of the mesh
    calls it and gets the full ``(image (H, W, 3) f32 CPU tensor,
    RenderStats)``. spp must divide over the sample axis; the sample range
    starts at ``sample_start`` (streams are keyed by the absolute sample
    index, so chunks of a long render resume exactly)."""
    flat, totals, sec = sharded_sums(scene, camera, params, mesh, sample_start)
    t0 = time.perf_counter()
    image = (flat / params.samples_per_pixel).reshape(params.height, params.width, 3)
    rays, refl, bg, rec, samples, iters = totals
    return image, RenderStats(
        rays=rays, reflections=refl, background_hits=bg, recursion_depth_hits=rec,
        samples=samples, pixels=params.width * params.height, wavefront_iterations=iters,
        preprocess_seconds=sec["setup"], render_seconds=sec["trace"] + sec["collective"],
        transfer_seconds=sec["fetch"] + time.perf_counter() - t0)
