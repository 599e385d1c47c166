"""A dry run of the distributed paths: one sharded render and one sharded
training step, the counterpart of ``__graft_entry__.py``'s
``dryrun_multichip``.

    torchrun --nproc-per-node 1 -m zraytrace_tpu_torch.dryrun   # NCCL, a card per rank
    python -m zraytrace_tpu_torch.dryrun --ranks 2 [--cpu]      # gloo ranks started here
"""

from __future__ import annotations

import argparse
import math
import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["dryrun_multichip"]


def _dryrun(rank: int, world_size: int, device) -> dict:
    """The body, on every rank of a group of ``world_size``: the
    ``("data", "sample")`` mesh (two sample shards whenever the rank count
    allows), a render of the three-balls scene and one training step of
    every differentiable field toward it, with ``__graft_entry__.py``'s
    assertions."""
    from zraytrace_tpu_torch.config import RenderParams
    from zraytrace_tpu_torch.inverse import make_sharded_train_step, split_scene
    from zraytrace_tpu_torch.parallel.mesh import make_mesh, render_sharded
    from zraytrace_tpu_torch.scenes import three_balls

    n_sample = 2 if world_size % 2 == 0 and world_size > 1 else 1
    n_data = world_size // n_sample
    mesh = make_mesh(n_data=n_data, n_sample=n_sample, device=device)
    built = three_balls(mesh.device)
    width = height = 8 if (8 * 8) % n_data == 0 else n_data
    spp = 2 * n_sample

    params = RenderParams(width=width, height=height, samples_per_pixel=spp, max_depth=3)
    image, stats = render_sharded(built.scene, built.camera, params, mesh)
    assert tuple(image.shape) == (height, width, 3), image.shape
    assert stats.samples == width * height * spp, stats

    scene_params, static = split_scene(built.scene)
    scene_params = {f: v.detach().clone().requires_grad_(True)
                    for f, v in scene_params.items()}
    before = {f: v.detach().clone() for f, v in scene_params.items()}
    step_fn, _ = make_sharded_train_step(mesh, scene_params, static, built.camera, width,
                                         height, spp=spp, max_depth=3)
    loss = float(step_fn(image.reshape(-1, 3)))
    assert math.isfinite(loss), loss
    moved = any(not torch.allclose(scene_params[f].detach(), before[f]) for f in before)
    assert moved, "training step did not update any parameter"
    for f, v in scene_params.items():
        assert bool(torch.isfinite(v).all()), f"non-finite params in {f}"
    return dict(rank=rank, mesh=(n_data, n_sample), loss=loss, rays=stats.rays,
                image_sum=float(np.float64(image.double().sum())))


def dryrun_multichip(n: int, device="cuda") -> list:
    """Run ``_dryrun`` over a group of ``n`` ranks: this process's group
    if it has joined one (of ``n`` ranks); else a group of one rank here
    (``n == 1``: NCCL on the card, gloo on the CPU) or ``n`` ranks started
    with ``multihost.run_ranks`` (gloo, all on ``device``). Returns each
    rank's summary (this rank's alone in a group joined before). Raises
    without a card when ``device`` is the card."""
    from zraytrace_tpu_torch.parallel import multihost

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("dryrun_multichip(device='cuda') but no CUDA device is available")
    if dist.is_initialized():
        if dist.get_world_size() != n:
            raise ValueError(f"the group has {dist.get_world_size()} ranks, not {n}")
        return [_dryrun(dist.get_rank(), n, dev)]
    if n > 1:
        if dev.type == "cuda" and dev.index is None:  # gloo ranks sharing the current card
            dev = torch.device("cuda", torch.cuda.current_device())
        return multihost.run_ranks(_dryrun, n, dev, backend="gloo", device=dev)
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    with tempfile.TemporaryDirectory() as tmp:
        multihost.initialize(backend="nccl" if dev.type == "cuda" else "gloo",
                             init_method=f"file://{os.path.join(tmp, 'rendezvous')}",
                             world_size=1, rank=0)
        try:
            return [_dryrun(0, 1, dev)]
        finally:
            dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=None,
                    help="ranks to start here (default: the torchrun group's, else 1)")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = ap.parse_args(argv)
    from zraytrace_tpu_torch.parallel import multihost

    multihost.initialize()
    dev = "cpu" if args.cpu else "cuda"
    if dist.is_initialized() and dev == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    n = args.ranks or multihost.global_device_count()
    for out in dryrun_multichip(n, dev):
        print(f"dryrun_multichip rank {out['rank']}: mesh {out['mesh']}, loss {out['loss']:.6g}, "
              f"rays {out['rays']}")
    if multihost.is_coordinator():
        print("dryrun_multichip OK")
    if dist.is_initialized():
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
