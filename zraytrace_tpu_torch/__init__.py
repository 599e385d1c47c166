"""zraytrace_tpu_torch — the PyTorch / CUDA port of zraytrace_tpu.

The JAX package ``zraytrace_tpu`` stays the reference; this package renders
the same scenes with the same stateless PCG4D streams and event counters.
Plain functions on tensors, an explicit ``device`` argument everywhere
(the card by default), and no global RNG state. On a CUDA device the
bounce loop runs in a hand-written Hopper kernel (``csrc/bounce_kernel.cu``,
whose mesh mode walks the mesh's BVH per ray in place, ``csrc/tri_bvh.cuh``,
to the flash triangle winner's result); on the CPU it runs the plain
PyTorch wavefront that the kernel is tested against, only when the caller
asks for the CPU.

Currently ported: the forward render path of sphere scenes (scene 1) and
mesh scenes (0, 2, 3, 4), and the differentiable path (``render_diff``,
edge and REINFORCE gradients, ``inverse.fit``), whose mesh winner pass
and silhouette-margin selection launch ``csrc/flash_intersect.cu`` and
``csrc/flash_margins.cu`` on the card. Checkpoints and the sharded paths
are listed in ROADMAP.md.
"""

import torch

__version__ = "0.1.0"

# Float32 policy: full f32 everywhere, never TF32. The reference learned
# this the hard way: reduced-precision products in the sphere quadratic
# (|o|^2 - 2 o.c + |c|^2 - r^2 with r = 100 for the ground sphere) cancel
# catastrophically and produce phantom hits. The port computes dot
# products as explicit component sums, but any matmul or convolution that
# does run must not silently drop to TF32.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from zraytrace_tpu_torch.camera import Camera  # noqa: E402
from zraytrace_tpu_torch.config import RenderParams  # noqa: E402
from zraytrace_tpu_torch.scene import Scene  # noqa: E402

__all__ = ["RenderParams", "Scene", "Camera", "__version__"]
