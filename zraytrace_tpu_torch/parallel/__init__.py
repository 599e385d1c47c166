"""Renders and training steps split over the ranks of a process group
(``torch.distributed``): ``multihost`` joins or starts the group,
``mesh`` forms the ``("data", "sample")`` mesh and renders over it,
``primshard`` splits a mesh's triangles."""

from zraytrace_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    SAMPLE_AXIS,
    Mesh,
    make_mesh,
    render_sharded,
)

__all__ = ["DATA_AXIS", "SAMPLE_AXIS", "Mesh", "make_mesh", "render_sharded"]
