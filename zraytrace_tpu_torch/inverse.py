"""Inverse rendering: recover scene parameters from a target image.

Counterpart of ``zraytrace_tpu/inverse.py``: gradient descent on the float
leaves of ``Scene`` through ``render_diff``. The sharded training step
(``make_sharded_train_step``) waits for the port of the distributed paths
(ROADMAP.md Queue 1, item 12), and fit checkpoints for ``checkpoint.py``
(item 9).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from zraytrace_tpu_torch import camera as cam
from zraytrace_tpu_torch.render_diff import MESH_FAST_MIN_TRIANGLES, render_diff
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
    """

    def loss_fn(params, eps_scale=None):
        scene = merge_scene(params, static)
        tf = None
        if tri_order is not None:
            from zraytrace_tpu_torch.ops.flash_intersect import pack_tri_planes

            with torch.no_grad():
                tf = pack_tri_planes(scene.tri_a.detach(), scene.tri_b.detach(),
                                     scene.tri_c.detach(), order=tri_order)
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
        edge_eps=None, coarse_to_fine: float = 1.0,
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
    ``checkpoint_path`` is not supported yet (it raises).
    """
    if checkpoint_path is not None:
        raise NotImplementedError("fit checkpoints wait for the port of checkpoint.py "
                                  "(ROADMAP.md Queue 1, item 9)")
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

    tri_order = None
    if scene_init.n_triangles >= MESH_FAST_MIN_TRIANGLES and device.type == "cuda":
        from zraytrace_tpu_torch.geometry.bvh import build_tri_bvh

        tri_order = build_tri_bvh(scene_init.tri_a, scene_init.tri_b,
                                  scene_init.tri_c).prim_order
    loss_fn = make_loss_fn(static, camera, target, width, height, spp, max_depth, seed,
                           edge_eps=edge_eps, tri_order=tri_order, edge_screen=edge_screen)

    def eps_scale_at(i):
        if coarse_to_fine == 1.0 or edge_eps is None:
            return None
        frac = min(1.0, i / max(1, int(0.6 * steps)))
        return float(np.float32(coarse_to_fine ** (1.0 - frac)))

    losses = []
    for i in range(steps):
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(params, eps_scale_at(i))
        loss.backward()
        if fd_fields:
            # the loss value does not depend on the edge bandwidth, so FD
            # sees the unscaled loss
            for f, g in fd_gradients(loss_fn, params, fd_fields).items():
                if params[f].requires_grad:
                    params[f].grad = g
        opt.step()
        losses.append(loss.detach())
    final = {f: v.detach() for f, v in params.items()}
    return FitResult(merge_scene(final, static), torch.stack(losses))
