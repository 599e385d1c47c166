"""The one-process contract ``parallel.mesh.sharded_sums`` is held to, for
the tests and ``chip_smoke.py``:

    from sharded_reference import reference_sums

(pytest puts this directory on ``sys.path``; ``chip_smoke.py`` adds it.)
"""

import torch

from zraytrace_tpu_torch import RenderParams
from zraytrace_tpu_torch.camera import Camera
from zraytrace_tpu_torch.render import (add_blocks, fetch_sums, lanes, mesh_routing,
                                        sample_blocks, trace_lanes)
from zraytrace_tpu_torch.scene import Scene


def reference_sums(scene: Scene, camera: Camera, params: RenderParams, n_data: int,
                   n_sample: int = 1, device="cpu", sample_start: int = 0):
    """``sharded_sums``' pixel sums and counters on an ``n_data`` x
    ``n_sample`` mesh, made in one process on ``device``: ``render()``'s
    lanes (``render.trace_lanes``) over each sample shard's blocks, a
    shard's block sums added in block order, then the shards' in shard
    order (``render.add_blocks``). ``(sums (H*W, 3) f32 CPU tensor,
    counters list of ints)``. ``sharded_sums`` gives these bits wherever at
    most two sample shards meet in the all-reduce: two nonzero terms and
    zeros add to one value in any order."""
    device = torch.device(device)
    spp_local = params.samples_per_pixel // n_sample
    scene, camera = scene.to(device), camera.to(device)
    lay = lanes(params.width, params.height, params.max_wavefront, device)
    route = mesh_routing(scene, device)
    sums, counters = add_blocks([
        add_blocks([trace_lanes(route, scene, camera, lay, params.seed, count, params.max_depth,
                                sample_start + s * spp_local + off)
                    for off, count in sample_blocks(spp_local, n_data)])
        for s in range(n_sample)])
    return fetch_sums(sums, lay), counters.tolist()
