"""Inverse rendering: recover scene parameters from a target image.

Counterpart of ``zraytrace_tpu/inverse.py``: gradient descent on the float
leaves of ``Scene`` through ``render_diff``, with checkpoints that resume a
fit (``checkpoint.py``), and the training step split over the ranks of a
``("data", "sample")`` mesh (``make_sharded_train_step``): pixels over
``data``, samples over ``sample``, the parameters' gradients all-reduced
so that every rank takes the same Adam step.
"""

from __future__ import annotations

import warnings
from typing import NamedTuple

import numpy as np
import torch

from zraytrace_tpu_torch import camera as cam
from zraytrace_tpu_torch.profiling import span
from zraytrace_tpu_torch.render_diff import MESH_FAST_MIN_TRIANGLES, render_diff, trace_samples
from zraytrace_tpu_torch.scene import Scene

# Differentiable leaves of Scene (the rest is integer structure).
DIFF_FIELDS = (
    "sph_center", "sph_radius", "tri_a", "tri_b", "tri_c",
    "mat_ior", "tex_color", "atlas",
)


def split_scene(scene: Scene):
    """Scene -> (params dict, static dict)."""
    params = {f: getattr(scene, f) for f in DIFF_FIELDS}
    static = {f: getattr(scene, f) for f in Scene._fields if f not in DIFF_FIELDS}
    return params, static


def merge_scene(params: dict, static: dict) -> Scene:
    return Scene(**params, **static)


def image_loss(img, target):
    """Mean squared error over pixels and channels."""
    return ((img - target) ** 2).mean()


def _bvh_order(scene: Scene, device: torch.device):
    """A host BVH-leaf triangle order of a mesh of at least 64 triangles
    on a CUDA device; None otherwise."""
    if scene.n_triangles < MESH_FAST_MIN_TRIANGLES or device.type != "cuda":
        return None
    from zraytrace_tpu_torch.geometry.bvh import build_tri_bvh

    return build_tri_bvh(scene.tri_a, scene.tri_b, scene.tri_c).prim_order


def _repack(scene: Scene, tri_order):
    """Original-id planes in ``tri_order`` from the current vertices, with
    no gradient (a ``diff.pack`` span); None without an order."""
    if tri_order is None:
        return None
    from zraytrace_tpu_torch.ops.flash_intersect import pack_tri_planes

    with torch.no_grad(), span("diff.pack"):
        return pack_tri_planes(scene.tri_a.detach(), scene.tri_b.detach(), scene.tri_c.detach(),
                               order=tri_order)


def make_loss_fn(static, camera, target, width, height, spp, max_depth, seed=42,
                 edge_eps=None, tri_order=None, edge_screen: bool = False):
    """The loss over the full image, ``loss_fn(params, eps_scale=None)``.

    ``edge_eps`` adds the edge factors (the loss value is unchanged, its
    gradient gains visibility terms); ``eps_scale`` multiplies the
    bandwidths (a coarse-to-fine schedule). ``tri_order``: a BVH-leaf
    triangle order (from the initial vertices): each evaluation repacks
    original-id planes in that order from the current vertices, with no
    gradient, and routes the winner pass and the margin selection through
    them. Chunk boxes always come from the current vertices, so the
    result does not depend on the order; only the chunks' tightness does.
    Each call is a ``fit.loss`` span, the repack a ``diff.pack`` inside it.
    """

    @span("fit.loss")
    def loss_fn(params, eps_scale=None):
        scene = merge_scene(params, static)
        tf = _repack(scene, tri_order)
        eps = edge_eps
        if eps is not None and eps_scale is not None:
            eps = (tuple(e * eps_scale for e in eps) if isinstance(eps, (tuple, list))
                   else eps * eps_scale)
        img = render_diff(scene, camera, width, height, spp, max_depth, seed=seed,
                          edge_eps=eps, tri_flash=tf, edge_screen=edge_screen,
                          mesh_fast=True if tf is not None else None)
        return image_loss(img, target)

    return loss_fn


def fd_gradients(loss_fn, params: dict, fields: tuple, eps: float = 2e-3) -> dict:
    """Central-difference gradients of ``loss_fn`` for a few
    low-dimensional fields (2 renders per scalar). The RNG is stateless, so
    the two renders share their sample streams and the difference measures
    the true derivative, visibility included."""
    grads = {}
    with torch.no_grad():
        for f in fields:
            arr = params[f].detach().cpu().numpy()
            flat = arr.ravel().astype(np.float64)
            g = np.zeros_like(flat)
            for i in range(flat.size):
                for sign in (1.0, -1.0):
                    p = flat.copy()
                    p[i] += sign * eps
                    x = torch.from_numpy(p.reshape(arr.shape).astype(np.float32))
                    g[i] += sign * float(loss_fn({**params, f: x.to(params[f].device)}))
                g[i] /= 2.0 * eps
            grads[f] = torch.from_numpy(g.reshape(arr.shape).astype(np.float32)).to(
                params[f].device)
    return grads


class FitResult(NamedTuple):
    scene: Scene
    losses: torch.Tensor  # (steps,) the loss before each step's update


def fit(scene_init: Scene, camera: cam.Camera, target, width: int, height: int, spp: int = 4,
        max_depth: int = 4, steps: int = 100, learning_rate: float = 1e-2, seed: int = 42,
        optimize_fields: tuple = DIFF_FIELDS, fd_fields: tuple = (), checkpoint_path=None,
        checkpoint_every: int = 10, edge_eps=None, coarse_to_fine: float = 1.0,
        edge_screen: bool = False, device="cuda") -> FitResult:
    """Gradient-descend scene parameters toward a target image on
    ``device`` (``zraytrace_tpu/inverse.py:129``).

    Only ``optimize_fields`` move, with Adam (``lr``, betas (0.9, 0.999),
    eps 1e-8: optax's ``adam``). Only the live fields (``optimize_fields``
    and ``fd_fields``) are differentiated; frozen leaves enter the loss as
    plain tensors, so e.g. the atlas adjoint is never built for a fit that
    does not move texels. ``fd_fields``: fields whose gradients come from
    central differences (``fd_gradients``) instead. ``edge_eps``: edge
    factors. ``coarse_to_fine``: start the edge bandwidth at
    ``coarse_to_fine * edge_eps`` and decay it geometrically to ``edge_eps``
    over the first 60% of the steps (1.0 = off). On a CUDA device a mesh of
    at least 64 triangles gets a BVH order from the initial vertices, so
    each step repacks planes and launches the winner and margin kernels.
    ``checkpoint_path``: save the live parameters, Adam's state, the step
    and the losses every ``checkpoint_every`` steps and after the last,
    and resume from the file if it exists (``checkpoint.py``). The
    fingerprint covers the JAX package's fields (not the target); steps
    join it only while the coarse-to-fine schedule is on, so a plain fit
    can be extended by resuming with more steps. Each step is a
    ``fit.step`` span with ``fit.loss``, ``fit.backward``, ``fit.adam`` and
    ``fit.checkpoint`` inside (``profiling``).
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("fit(device='cuda') but no CUDA device is available")
    scene_init = scene_init.to(device)
    camera = camera.to(device)
    target = torch.as_tensor(target, dtype=torch.float32).to(device)
    params, static = split_scene(scene_init)
    live = set(optimize_fields) | set(fd_fields)
    static = {**static, **{f: v for f, v in params.items() if f not in live}}
    params = {f: v.detach().clone().requires_grad_(f in optimize_fields)
              for f, v in params.items() if f in live}
    opt = torch.optim.Adam([params[f] for f in DIFF_FIELDS if f in optimize_fields],
                           lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)

    loss_fn = make_loss_fn(static, camera, target, width, height, spp, max_depth, seed,
                           edge_eps=edge_eps, tri_order=_bvh_order(scene_init, device),
                           edge_screen=edge_screen)

    def eps_scale_at(i):
        if coarse_to_fine == 1.0 or edge_eps is None:
            return None
        frac = min(1.0, i / max(1, int(0.6 * steps)))
        return float(np.float32(coarse_to_fine ** (1.0 - frac)))

    losses = []
    start, fp = 0, ""
    if checkpoint_path:
        from zraytrace_tpu_torch.checkpoint import load_fit_checkpoint, scene_fingerprint

        sched_on = coarse_to_fine != 1.0 and edge_eps is not None
        fp = scene_fingerprint(static, camera, extra=(
            width, height, spp, max_depth, seed, learning_rate, tuple(sorted(optimize_fields)),
            tuple(sorted(fd_fields)), float(coarse_to_fine), repr(edge_eps), repr(edge_screen),
            int(steps) if sched_on else -1))
        resumed = load_fit_checkpoint(checkpoint_path, params, opt, fp)
        if resumed is not None:
            start, saved = resumed
            losses = [torch.tensor(float(v), device=device) for v in saved]

    for i in range(start, steps):
        with span("fit.step"):
            opt.zero_grad(set_to_none=True)
            loss = loss_fn(params, eps_scale_at(i))
            with span("fit.backward"):
                loss.backward()
                if fd_fields:
                    # the loss value does not depend on the edge bandwidth, so FD
                    # sees the unscaled loss
                    for f, g in fd_gradients(loss_fn, params, fd_fields).items():
                        if params[f].requires_grad:
                            params[f].grad = g
            with span("fit.adam"):
                opt.step()
            losses.append(loss.detach())
            if checkpoint_path and ((i + 1) % checkpoint_every == 0 or i + 1 == steps):
                from zraytrace_tpu_torch.checkpoint import save_fit_checkpoint

                with span("fit.checkpoint"):
                    save_fit_checkpoint(checkpoint_path, params, opt, i + 1, losses, fp)
    final = {f: v.detach() for f, v in params.items()}
    return FitResult(merge_scene(final, static), torch.stack(losses))


def make_sharded_train_step(mesh, params: dict, static: dict, camera: cam.Camera, width: int,
                            height: int, spp: int, max_depth: int, learning_rate: float = 1e-2,
                            seed: int = 42, edge_eps=None, edge_screen: bool = False):
    """One Adam step of ``make_loss_fn``'s loss split over ``mesh``
    (``parallel.mesh.make_mesh``), the counterpart of the JAX package's
    ``make_sharded_train_step`` (``zraytrace_tpu/inverse.py:277``).
    Returns ``(step_fn, optimizer)``: ``step_fn(target)`` (the full image,
    ``(H, W, 3)`` or ``(H*W, 3)``, on every rank) updates ``params``
    (field -> leaf tensor on ``mesh.device``, requiring grad) in place and
    returns the loss, the same on every rank. Collective: every rank of
    the mesh calls it, with the same parameters.

    Rank ``(i, j)`` traces pixels ``[i, i + 1) * H*W / n_data`` (which must
    divide) for samples ``[j, j + 1) * spp / n_sample`` through
    ``render_diff``'s sample loop (``trace_samples``: grouped lanes, with
    the REINFORCE baseline of the running mean of the pixel's earlier
    samples; where ``mat_ior`` is trained through a dielectric on several
    sample ranks, a no-grad pass of the same loop first sums the earlier
    ranks' samples). The partial image is summed over ``sample`` by the
    differentiable all-reduce (``torch.distributed.nn.functional.
    all_reduce``, whose backward sums the sample ranks' gradients of the
    image), the squared error over ``data``. Each rank's loss is its share
    divided by the sample count, so that the parameter gradients,
    all-reduced over every rank, are the gradient of the whole loss and
    not ``n_sample`` times it; Adam then steps identically everywhere. On
    the card a mesh of at least 64 triangles repacks planes in a BVH order
    each step, so the winner pass and, with ``edge_eps``, the margin
    selection launch their kernels.
    """
    import torch.distributed as dist
    from torch.distributed.nn.functional import all_reduce as all_reduce_diff

    from zraytrace_tpu_torch import vecmath as vm
    from zraytrace_tpu_torch.parallel.mesh import DATA_AXIS, SAMPLE_AXIS, check_replicated
    from zraytrace_tpu_torch.scene import DIELECTRIC

    n_pixels = width * height
    n_data, n_sample = mesh.shape[DATA_AXIS], mesh.shape[SAMPLE_AXIS]
    if n_pixels % n_data or spp % n_sample:
        raise ValueError(f"{n_pixels} pixels and {spp} spp must divide over the "
                         f"{n_data}x{n_sample} mesh")
    dev = mesh.device
    p_l, s_l = n_pixels // n_data, spp // n_sample
    d_i, s_i = mesh.coords
    pixel_ids = torch.arange(d_i * p_l, (d_i + 1) * p_l, dtype=torch.int32, device=dev)
    data_group, sample_group = mesh.group(DATA_AXIS), mesh.group(SAMPLE_AXIS)
    check_replicated(list(params.values()), "parameters")
    optimizer = torch.optim.Adam(list(params.values()), lr=learning_rate,
                                 betas=(0.9, 0.999), eps=1e-8)

    first = merge_scene({f: v.detach() for f, v in params.items()}, static)
    tri_order = _bvh_order(first, dev)
    if tri_order is not None:
        check_replicated([tri_order.to(dev)], "BVH orders")
    ior = params.get("mat_ior")
    prefix_pass = (n_sample > 1 and ior is not None and ior.requires_grad
                   and bool((first.mat_type == DIELECTRIC).any()))

    def step_fn(target):
        target = torch.as_tensor(target, dtype=torch.float32, device=dev).reshape(n_pixels, 3)
        target_local = target[d_i * p_l:(d_i + 1) * p_l]
        optimizer.zero_grad(set_to_none=True)
        scene = merge_scene(params, static)
        tf = _repack(scene, tri_order)

        def samples(s, stop_total):
            """Sample rank ``s``'s samples of this rank's pixels."""
            return trace_samples(scene, camera, pixel_ids, range(s * s_l, (s + 1) * s_l), seed,
                                 width, height, max_depth, stop_total, s * s_l,
                                 edge_eps=edge_eps, mesh_fast=True if tf is not None else None,
                                 tri_flash=tf, edge_screen=edge_screen)

        stop_total = torch.zeros((p_l, 3), dtype=torch.float32, device=dev)
        if prefix_pass:
            # the REINFORCE baseline of sample k is the mean of samples < k:
            # sum the earlier sample ranks' detached radiance first
            mine = torch.zeros((n_sample, p_l, 3), dtype=torch.float32, device=dev)
            if s_i < n_sample - 1:
                with torch.no_grad():
                    mine[s_i] = samples(s_i, stop_total)[0]
            dist.all_reduce(mine, group=sample_group)
            for j in range(s_i):
                stop_total = stop_total + mine[j]
        total, _ = samples(s_i, stop_total)
        if n_sample > 1:
            with warnings.catch_warnings():  # deprecated for torch.compile, not for autograd
                warnings.simplefilter("ignore", FutureWarning)
                total = all_reduce_diff(total, group=sample_group)
        img = vm.div(total, float(spp))
        sq = ((img - target_local) ** 2).sum()
        (sq / float(3 * n_pixels * n_sample)).backward()
        grads = [p.grad for p in params.values() if p.grad is not None]
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat)  # one collective for every parameter's gradient
        for g, part in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(part.view_as(g))
        optimizer.step()
        loss = sq.detach().clone()
        dist.all_reduce(loss, group=data_group)
        return loss / float(3 * n_pixels)

    return step_fn, optimizer
