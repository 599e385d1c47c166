"""Checkpoint and resume for long renders and for fits.

Counterpart of ``zraytrace_tpu/checkpoint.py``. Monte Carlo accumulation
is a running sum, so a render checkpoint is its pixel sums, the samples
done and the counters. Sample streams are keyed by the absolute sample
index, so a resumed render continues the same streams and equals an
uninterrupted one at the same chunking bit for bit. A fit checkpoint is
the live parameters, the Adam state, the step and the losses; the loss
is deterministic, so a resumed fit continues the same trajectory.

Files are written atomically (a temporary file, then a rename), carry
this package's own magic (the JAX package's files are refused by it) and
a fingerprint of everything that shapes what they accumulate: a resume
against another scene, camera, engine, chunking or mesh raises instead
of blending two sums into one image.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
import os
import tempfile
import time

import numpy as np
import torch

from zraytrace_tpu_torch import camera as cam
from zraytrace_tpu_torch.config import RenderParams
from zraytrace_tpu_torch.render import N_COUNTERS, RenderStats
from zraytrace_tpu_torch.scene import Scene

__all__ = ["scene_fingerprint", "RenderCheckpoint", "save_checkpoint", "load_checkpoint",
           "save_fit_checkpoint", "load_fit_checkpoint", "render_checkpointed",
           "render_sharded_checkpointed"]

_MAGIC = "zraytrace_tpu_torch-render-v1"
_FIT_MAGIC = "zraytrace_tpu_torch-fit-v1"
# The layout of a fit checkpoint's arrays; a file of another format is
# refused with its own message rather than a missing-key error.
FIT_FORMAT = 1


def _leaves(tree):
    """``(name, leaf)`` pairs of a NamedTuple, dict (sorted by key),
    tuple or list of tensors, depth first."""
    if tree is None:
        return
    if isinstance(tree, torch.Tensor):
        yield "", tree
    elif hasattr(tree, "_fields"):
        for f in tree._fields:
            for name, x in _leaves(getattr(tree, f)):
                yield f + name, x
    elif isinstance(tree, dict):
        for k in sorted(tree):
            for name, x in _leaves(tree[k]):
                yield f"{k}{name}", x
    elif isinstance(tree, (tuple, list)):
        for i, t in enumerate(tree):
            for name, x in _leaves(t):
                yield f"{i}.{name}", x
    else:
        raise TypeError(f"cannot fingerprint a {type(tree).__name__}")


def scene_fingerprint(scene, camera=None, extra: tuple = ()) -> str:
    """sha256 over every field of ``scene`` and ``camera`` (a ``Scene``
    or a dict of its fields; tensors hashed from a CPU copy, with dtype
    and shape) and ``repr(extra)``."""
    h = hashlib.sha256()
    for name, leaf in _leaves((scene, camera)):
        arr = leaf.detach().cpu().contiguous().numpy()
        h.update(name.encode())
        h.update(str(arr.dtype).encode())
        h.update(str(arr.shape).encode())
        h.update(arr.tobytes())
    h.update(repr(extra).encode())
    return h.hexdigest()


@dataclasses.dataclass
class RenderCheckpoint:
    pixel_sum: np.ndarray  # (H*W, 3) f64 radiance sums
    counters: np.ndarray  # (N_COUNTERS,) int64 totals
    samples_done: int
    width: int
    height: int
    seed: int
    max_depth: int
    scene_hash: str  # scene_fingerprint of scene, camera and the run's layout


def _atomic_savez(path, **arrays) -> None:
    """``np.savez`` into a temporary file beside ``path``, then a rename,
    so an interrupt never leaves a torn file."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def save_checkpoint(path, ckpt: RenderCheckpoint) -> None:
    _atomic_savez(path, magic=_MAGIC, pixel_sum=ckpt.pixel_sum,
                  counters=np.asarray(ckpt.counters, np.int64),
                  samples_done=ckpt.samples_done, width=ckpt.width, height=ckpt.height,
                  seed=ckpt.seed, max_depth=ckpt.max_depth, scene_hash=ckpt.scene_hash)


def load_checkpoint(path) -> RenderCheckpoint | None:
    """The checkpoint at ``path``, or None if there is none. A file of
    another magic (the JAX package's among them) raises ValueError."""
    if not os.path.exists(path):
        return None
    with np.load(path, allow_pickle=False) as z:
        if "magic" not in z or str(z["magic"]) != _MAGIC:
            raise ValueError(f"{path} is not a {_MAGIC} checkpoint")
        return RenderCheckpoint(
            pixel_sum=z["pixel_sum"], counters=z["counters"],
            samples_done=int(z["samples_done"]), width=int(z["width"]),
            height=int(z["height"]), seed=int(z["seed"]), max_depth=int(z["max_depth"]),
            scene_hash=str(z["scene_hash"]))


def save_fit_checkpoint(path, params: dict, optimizer: torch.optim.Optimizer, step: int,
                        losses, fingerprint: str) -> None:
    """Save a fit: the live parameters ``params`` (field -> tensor), the
    Adam state of those ``optimizer`` holds (``step``, ``exp_avg``,
    ``exp_avg_sq``), the step count and the losses so far."""
    arrays = {}
    for f, p in params.items():
        arrays[f"param_{f}"] = p.detach().cpu().numpy()
        state = optimizer.state.get(p, {})
        for k in ("step", "exp_avg", "exp_avg_sq"):
            if k in state:
                arrays[f"adam_{k}_{f}"] = torch.as_tensor(state[k]).detach().cpu().numpy()
    losses = np.asarray([float(x) for x in losses], np.float32)
    _atomic_savez(path, magic=_FIT_MAGIC, format=FIT_FORMAT, live=",".join(sorted(params)),
                  step=step, losses=losses, fingerprint=fingerprint, **arrays)


def load_fit_checkpoint(path, params: dict, optimizer: torch.optim.Optimizer,
                        fingerprint: str):
    """Restore a fit saved by ``save_fit_checkpoint`` into ``params`` and
    ``optimizer`` in place; returns ``(step, losses (K,) f32 array)``, or
    None if ``path`` does not exist. Raises ValueError on another magic,
    format, live-field set or fingerprint."""
    if not os.path.exists(path):
        return None
    with np.load(path, allow_pickle=False) as z:
        if "magic" not in z or str(z["magic"]) != _FIT_MAGIC:
            raise ValueError(f"{path} is not a {_FIT_MAGIC} checkpoint")
        fmt = int(z["format"]) if "format" in z else 0
        if fmt != FIT_FORMAT:
            raise ValueError(f"fit checkpoint {path} has format {fmt}, this version reads "
                             f"{FIT_FORMAT}: start the fit afresh")
        live = ",".join(sorted(params))
        if str(z["live"]) != live:
            raise ValueError(f"fit checkpoint {path} holds the live fields {str(z['live'])!r}, "
                             f"this fit optimizes {live!r}")
        if str(z["fingerprint"]) != fingerprint:
            raise ValueError(f"fit checkpoint {path} was written for a different "
                             "scene/target/config")
        with torch.no_grad():
            for f, p in params.items():
                p.copy_(torch.from_numpy(z[f"param_{f}"]).to(p.device))
                if f"adam_step_{f}" not in z:
                    optimizer.state.pop(p, None)
                    continue
                step = torch.from_numpy(z[f"adam_step_{f}"].copy())
                optimizer.state[p] = {
                    "step": step,
                    "exp_avg": torch.from_numpy(z[f"adam_exp_avg_{f}"]).to(p.device),
                    "exp_avg_sq": torch.from_numpy(z[f"adam_exp_avg_sq_{f}"]).to(p.device)}
        return int(z["step"]), z["losses"].copy()


def _restore_or_init(path, fp: str, params: RenderParams, n: int):
    """Validate and restore a render checkpoint, or start afresh: returns
    ``(pixel_sum (n, 3) f64, counters list of N_COUNTERS ints, done)``."""
    ckpt = load_checkpoint(path)
    if ckpt is None:
        return np.zeros((n, 3), np.float64), [0] * N_COUNTERS, 0
    if (ckpt.width, ckpt.height, ckpt.seed, ckpt.max_depth) != (
            params.width, params.height, params.seed, params.max_depth):
        raise ValueError(f"checkpoint {path} does not match render config")
    if ckpt.scene_hash != fp:
        raise ValueError(f"checkpoint {path} was written for a different scene/camera/engine/"
                         "chunking/mesh: refusing to blend sample sums")
    if ckpt.samples_done > params.samples_per_pixel:
        raise ValueError(f"checkpoint {path} holds {ckpt.samples_done} samples per pixel, "
                         f"more than the {params.samples_per_pixel} asked for")
    return (ckpt.pixel_sum.astype(np.float64), [int(x) for x in ckpt.counters],
            ckpt.samples_done)


def _chunk_step(total: int, done: int, chunk: int) -> int:
    """The next chunk: ``min(chunk, remaining)``. The plan depends only
    on ``done``, so a run cut short and resumed chunks as an
    uninterrupted one does."""
    return min(chunk, total - done)


def _final_stats(pixel_sum, counters, params: RenderParams, n: int, elapsed: float):
    """The image ``(H, W, 3)`` f32 CPU tensor and ``RenderStats`` from the
    accumulated sums and counters."""
    image = (pixel_sum / params.samples_per_pixel).reshape(
        params.height, params.width, 3).astype(np.float32)
    rays, refl, bg, rec, samples, iters = counters
    return torch.from_numpy(image), RenderStats(
        rays=rays, reflections=refl, background_hits=bg, recursion_depth_hits=rec,
        samples=samples, pixels=n, wavefront_iterations=iters, render_seconds=elapsed)


def _engine(device: torch.device) -> str:
    """The engine a device runs: the CUDA kernel, or the plain wavefront."""
    return "cuda" if device.type == "cuda" else "cpu"


def render_checkpointed(scene: Scene, camera: cam.Camera, params: RenderParams, path,
                        chunk_spp: int = 50, device="cuda"):
    """Render with a checkpoint written to ``path`` every ``chunk_spp``
    samples, resuming from it if present. Returns ``(image (H, W, 3) f32
    CPU tensor, RenderStats)``.

    Each chunk is one trace of ``render()``'s lanes and slots from
    ``sample_start = done`` through ``render()``'s route
    (``render.mesh_routing``): on a CUDA device the bounce kernel (mesh
    scenes in its mesh mode, over planes made once per mesh; a mesh with
    image-textured materials in the wavefront with the flash kernel), on
    the CPU the plain wavefront. The chunk's f32 slot sums are added on
    the host into f64 pixel sums, its counters into exact integers. A
    resumed run equals an uninterrupted one at the same chunking bit for
    bit; against ``render()`` the counters are equal, the image differs by
    the order of the adds. ``wavefront_iterations`` sums the chunks'.
    """
    from zraytrace_tpu_torch.ops.bounce_kernel import library
    from zraytrace_tpu_torch.render import mesh_routing, trace_route

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("render_checkpointed(device='cuda') but no CUDA device is available")
    if chunk_spp <= 0:
        raise ValueError("chunk_spp must be positive")
    if device.type == "cuda":
        library()
    w, h = params.width, params.height
    n = w * h
    n_lanes = min(n, params.max_wavefront)
    n_slots = math.ceil(n / n_lanes)
    scene = scene.to(device)
    camera = camera.to(device)
    fp = scene_fingerprint(scene, camera, extra=(chunk_spp, _engine(device), n_lanes, n_slots))
    pixel_sum, counters, done = _restore_or_init(path, fp, params, n)
    route = mesh_routing(scene, device)
    base = torch.arange(n_lanes, dtype=torch.int32, device=device)

    t0 = time.perf_counter()
    while done < params.samples_per_pixel:
        step = _chunk_step(params.samples_per_pixel, done, chunk_spp)
        sums, cnt = trace_route(route, scene, camera, base, params.seed, w, h, step,
                                params.max_depth, done, n_lanes, n, n_slots)
        counters = [a + b for a, b in zip(counters, cnt.cpu().tolist())]
        pixel_sum += sums.reshape(n_slots * n_lanes, 3)[:n].cpu().numpy().astype(np.float64)
        done += step
        save_checkpoint(path, RenderCheckpoint(
            pixel_sum=pixel_sum, counters=np.asarray(counters, np.int64), samples_done=done,
            width=w, height=h, seed=params.seed, max_depth=params.max_depth, scene_hash=fp))
    return _final_stats(pixel_sum, counters, params, n, time.perf_counter() - t0)


def render_sharded_checkpointed(scene: Scene, camera: cam.Camera, params: RenderParams, mesh,
                                path, chunk_spp: int = 50):
    """``render_checkpointed`` over a ``parallel.mesh.make_mesh`` mesh:
    each chunk is one ``render_sharded`` from ``sample_start = done``.
    ``chunk_spp`` and spp must be multiples of the mesh's sample axis.
    The mesh's shape and the world size join the fingerprint, so a
    checkpoint resumes only on the mesh that wrote it. Every rank reads
    the file; rank 0 alone writes it. Collective: every rank of the mesh
    calls it. Returns ``(image, RenderStats)`` on every rank."""
    import torch.distributed as dist

    from zraytrace_tpu_torch.parallel.mesh import DATA_AXIS, SAMPLE_AXIS, sharded_sums

    n_data, n_sample = mesh.shape[DATA_AXIS], mesh.shape[SAMPLE_AXIS]
    if chunk_spp <= 0 or chunk_spp % n_sample:
        raise ValueError(f"chunk_spp={chunk_spp} must be a positive multiple of the sample "
                         f"axis size {n_sample}")
    if params.samples_per_pixel % n_sample:
        raise ValueError(f"spp={params.samples_per_pixel} must divide over sample axis "
                         f"{n_sample}")
    w, h = params.width, params.height
    n = w * h
    n_lanes = min(n, params.max_wavefront)
    fp = scene_fingerprint(scene, camera, extra=(
        chunk_spp, "sharded", _engine(mesh.device), (n_data, n_sample),
        dist.get_world_size(), n_lanes, math.ceil(n / n_lanes)))
    pixel_sum, counters, done = _restore_or_init(path, fp, params, n)
    agree = torch.tensor([done, -done], dtype=torch.int64, device=mesh.device)
    dist.all_reduce(agree, dist.ReduceOp.MAX)
    if int(agree[0]) != done or int(agree[1]) != -done:
        raise RuntimeError(f"the ranks read different checkpoints from {path}")

    t0 = time.perf_counter()
    while done < params.samples_per_pixel:
        step = _chunk_step(params.samples_per_pixel, done, chunk_spp)
        sums, cnt, _ = sharded_sums(scene, camera, dataclasses.replace(
            params, samples_per_pixel=step), mesh, sample_start=done)
        counters = [a + b for a, b in zip(counters, cnt)]
        pixel_sum += sums.numpy().astype(np.float64)
        done += step
        if dist.get_rank() == 0:
            save_checkpoint(path, RenderCheckpoint(
                pixel_sum=pixel_sum, counters=np.asarray(counters, np.int64),
                samples_done=done, width=w, height=h, seed=params.seed,
                max_depth=params.max_depth, scene_hash=fp))
    # no rank reads the file again before rank 0 has written it
    dist.barrier()
    return _final_stats(pixel_sum, counters, params, n, time.perf_counter() - t0)
