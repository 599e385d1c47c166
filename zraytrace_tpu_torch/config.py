"""Render configuration.

Mirrors the reference ``RenderParams`` (raytrace.zig:102-108) and the JAX
package's ``zraytrace_tpu/config.py``. The TPU megakernel knobs
(``pallas_*``, balance, sample groups) have no counterpart here: the CUDA
kernel needs none of them.
"""

from __future__ import annotations

import dataclasses

# Global dtype policy: f32 compute everywhere, matching the reference's
# ``BaseFloat = f32`` (base.zig:2). TF32 is switched off on import
# (package ``__init__``).

# t-interval for valid intersections (raytrace.zig:71-72).
T_MIN = 1e-3


@dataclasses.dataclass(frozen=True)
class RenderParams:
    """Parameters of one render (raytrace.zig:102-108).

    ``bvh`` mirrors ``bounded_volume_hierarchy``; sphere-only scenes never
    build one (the reference auto-disables it for small scenes).
    """

    width: int = 400
    height: int = 400
    samples_per_pixel: int = 100
    max_depth: int = 30
    bvh: bool = True
    # Random seed for the stateless RNG streams.
    seed: int = 42
    # Maximum number of lanes in one wavefront (or CUDA threads in one
    # launch). Images with more pixels give each lane several strided
    # pixels (slots).
    max_wavefront: int = 1 << 20

    def __post_init__(self):
        if self.width <= 0 or self.height <= 0:
            raise ValueError("image dimensions must be positive")
        if self.samples_per_pixel <= 0:
            raise ValueError("samples_per_pixel must be positive")
        if self.max_depth <= 0:
            raise ValueError("max_depth must be positive")
        if self.max_wavefront <= 0:
            raise ValueError("max_wavefront must be positive")
