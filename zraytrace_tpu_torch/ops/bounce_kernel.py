"""The bounce kernel: the whole sphere-scene path loop in one CUDA launch.

Replaces the TPU bounce megakernel in sphere mode
(``zraytrace_tpu/ops/bounce_kernel3.py:222``, ``make_bounce_kernel3``,
driven by ``wavefront_trace_pallas3``). The source, with the design note
(one thread per lane, texels read directly from global memory, bounded
by per-ray FP32/SFU work and divergence rather than bytes, no wgmma or
TMA since there is no matrix work), is ``csrc/bounce_kernel.cu``.

``bounce_trace`` has the contract of the plain wavefront
``render.wavefront_trace``, which this module re-exports as
``wavefront_trace_reference``: on a CPU tensor the wrapper runs that plain
version; on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from zraytrace_tpu_torch.camera import Camera
from zraytrace_tpu_torch.render import N_COUNTERS, check_sphere_scene
from zraytrace_tpu_torch.render import wavefront_trace as wavefront_trace_reference
from zraytrace_tpu_torch.scene import Scene

__all__ = ["bounce_trace", "wavefront_trace_reference", "LAUNCHES", "library",
           "scene_tables"]

# Kernel launches made by ``bounce_trace`` in this process.
LAUNCHES = 0

# The kernel's shared-memory material table holds at most this many rows
# (csrc/bounce_kernel.cu MAX_MATS; render.MAX_SPHERES likewise).
MAX_MATS = 32

_I, _U, _P = ctypes.c_int, ctypes.c_uint, ctypes.c_void_p


def library() -> ctypes.CDLL:
    """The kernel's library, built from ``csrc/bounce_kernel.cu`` on first
    use (``ops/build.py``)."""
    from zraytrace_tpu_torch.ops.build import load

    lib = load("bounce_kernel")
    if lib.zr_bounce_launch.argtypes is None:
        lib.zr_bounce_launch.argtypes = [
            _P, _I, _P, _I, _P, _P, _I, _P, _I, _I, _I, _I, _I, _I, _U, _I, _I, _I,
            _P, _P, _P]
        lib.zr_bounce_launch.restype = _I
        lib.zr_error_string.argtypes = [_I]
        lib.zr_error_string.restype = ctypes.c_char_p
    return lib


def scene_tables(scene: Scene, camera: Camera):
    """The kernel's tables, as ``zraytrace_tpu/ops/common.py``
    ``prepare_tables`` lays them out: spheres ``(S, 5)`` [cx, cy, cz,
    radius, mat], materials ``(M, 11)`` [type, ior, textype, r, g, b,
    atlas base, u_off, v_off, tex_h, tex_w], camera ``(12,)``."""
    spheres = torch.cat([scene.sph_center, scene.sph_radius[:, None],
                         scene.sph_mat.to(torch.float32)[:, None]], dim=1)
    a_h, a_w = scene.atlas.shape[1], scene.atlas.shape[2]
    tex = scene.mat_tex.long()
    aid = scene.tex_image[tex].long()
    hw = scene.atlas_hw[aid].to(torch.float32)
    mats = torch.cat([
        scene.mat_type.to(torch.float32)[:, None],
        scene.mat_ior[:, None],
        scene.tex_type[tex].to(torch.float32)[:, None],
        scene.tex_color[tex],
        (aid * (a_h * a_w)).to(torch.float32)[:, None],
        scene.tex_offset[tex],
        hw], dim=1)
    return (spheres.contiguous(), mats.contiguous(),
            camera.flat().contiguous())


def bounce_trace(scene: Scene, camera: Camera, pixel_base: torch.Tensor, seed,
                 width, height, spp, max_depth, sample_start=0, pixel_stride=None,
                 n_pixels=None, n_slots: int = 1):
    """Trace samples ``[sample_start, sample_start + spp)`` of every pixel
    of every lane. Arguments and result are those of
    ``wavefront_trace_reference``: ``(slot_sums (n_slots, N, 3) f32,
    counters (6,) int64)``."""
    global LAUNCHES
    dev = pixel_base.device
    if dev.type == "cpu":
        return wavefront_trace_reference(
            scene, camera, pixel_base, seed, width, height, spp, max_depth,
            sample_start, pixel_stride, n_pixels, n_slots)
    if dev.type != "cuda":
        raise ValueError(f"bounce_trace runs on cpu or cuda tensors, not {dev.type}")

    check_sphere_scene(scene)  # <= render.MAX_SPHERES spheres, no triangles
    if scene.mat_type.shape[0] > MAX_MATS:
        raise ValueError(f"the kernel takes <= {MAX_MATS} materials")
    for name, t in zip(scene._fields, scene):
        if t.device != dev:
            raise ValueError(f"scene.{name} is on {t.device}, lanes on {dev}")
    for name, t in zip(camera._fields, camera):
        if t.device != dev:
            raise ValueError(f"camera.{name} is on {t.device}, lanes on {dev}")
    if pixel_base.dtype != torch.int32 or pixel_base.dim() != 1:
        raise ValueError("pixel_base must be a 1-D int32 tensor")
    if scene.atlas.dtype != torch.float32:
        raise ValueError("scene.atlas must be float32")

    if width <= 0 or height <= 0 or n_slots <= 0:
        raise ValueError("width, height and n_slots must be positive")
    n = pixel_base.shape[0]
    stride = n if pixel_stride is None else int(pixel_stride)
    n_pix = width * height if n_pixels is None else int(n_pixels)
    if n_pix >= 1 << 31 or n + (n_slots - 1) * stride >= 1 << 31:
        raise ValueError("pixel ids must fit in int32")
    if sample_start < 0 or sample_start + spp >= 1 << 31 or spp < 1:
        raise ValueError("sample range must lie in [0, 2^31)")
    base = pixel_base.contiguous()
    atlas = scene.atlas.contiguous()
    spheres, mats, cam = scene_tables(scene, camera)

    slot_sums = torch.zeros((n_slots, n, 3), dtype=torch.float32, device=dev)
    counters = torch.zeros((N_COUNTERS,), dtype=torch.int64, device=dev)
    lib = library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.zr_bounce_launch(
            spheres.data_ptr(), spheres.shape[0], mats.data_ptr(), mats.shape[0],
            cam.data_ptr(), atlas.data_ptr(), atlas.shape[2], base.data_ptr(), n,
            width, height, sample_start, spp, max_depth, int(seed) & 0xFFFFFFFF,
            stride, n_pix, n_slots, slot_sums.data_ptr(), counters.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(
            f"bounce kernel launch failed: {lib.zr_error_string(err).decode()}")
    LAUNCHES += 1
    return slot_sums, counters
