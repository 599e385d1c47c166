"""The bounce kernel: the whole path loop in one CUDA launch.

Replaces the TPU bounce megakernel (``zraytrace_tpu/ops/
bounce_kernel3.py:222``, ``make_bounce_kernel3``, driven by
``wavefront_trace_pallas3``) in sphere mode and in mesh mode. The source,
with the design note (one thread per lane, texels read directly from
global memory, in mesh mode a per-ray walk of the mesh's BVH run in place
for segments that reach the mesh, bounded by per-ray FP32/SFU work,
dependent loads and divergence rather than bytes, no wgmma or TMA since
there is no matrix work), is ``csrc/bounce_kernel.cu``; the walk is
``csrc/tri_bvh.cuh``, its tables and plain twin ``ops/mesh_bvh.py``.

``bounce_trace`` has the contract of the plain wavefront
``render.wavefront_trace``, which this module re-exports as
``wavefront_trace_reference``: on a CPU tensor the wrapper runs that plain
version; on a CUDA tensor it launches the kernel or raises. Each launch
adds to the store's counter ``launch.bounce`` (``profiling``), and in
mesh mode to ``launch.bounce_mesh`` too.
"""

from __future__ import annotations

import ctypes

import torch

from zraytrace_tpu_torch.camera import Camera
from zraytrace_tpu_torch.ops.flash_intersect import TriPlanes, check_planes
from zraytrace_tpu_torch.ops.mesh_bvh import WORK_FIELDS as BVH_WORK_FIELDS
from zraytrace_tpu_torch.ops.mesh_bvh import check_tables
from zraytrace_tpu_torch.profiling import count
from zraytrace_tpu_torch.render import MAX_SPHERES, N_COUNTERS, add_blocks, sample_blocks
from zraytrace_tpu_torch.render import wavefront_trace as wavefront_trace_reference
from zraytrace_tpu_torch.scene import Scene

__all__ = ["bounce_trace", "wavefront_trace_reference", "WORK_FIELDS", "simt", "check_mesh",
           "library", "bind", "scene_tables", "sphere_rows"]

# The kernel's shared-memory material table holds at most this many rows
# (csrc/bounce_kernel.cu MAX_MATS; render.MAX_SPHERES likewise).
MAX_MATS = 32

# The work counts ``bounce_trace(..., work=)`` receives, in order: the
# BVH walk's (node slab tests, leaves entered, triangle tests, and those
# passing det, t and u), then sphere tests with a positive discriminant,
# segments reaching the mesh root box and triangle hits; then the loop's
# SIMT counts: ``lane_steps``, the iterations in which a lane was alive
# (always rays + recursion-depth hits), ``warp_iters``, the iterations
# each warp ran, summed over warps, ``warp_branches``, the material
# branches (sky, texel fetch, Lambertian, metal, dielectric) each warp
# iteration ran, summed over iterations, and ``warp_nodes``, in mesh mode
# the node slab tests of each warp iteration's longest walk, summed (the
# walk loop's trips). ``lane_steps / (32 * warp_iters)`` is the share of
# issued lanes that did work; ``nodes / (32 * warp_nodes)`` the walk's.
WORK_FIELDS = BVH_WORK_FIELDS + ("disc", "root", "tri_hits", "lane_steps", "warp_iters",
                                 "warp_branches", "warp_nodes")

_I, _U, _P = ctypes.c_int, ctypes.c_uint, ctypes.c_void_p


def simt(work: dict, counters) -> dict:
    """The loop's SIMT figures from a counting launch's ``work`` (by
    ``WORK_FIELDS``) and its counters: ``efficiency``, ``lane_steps / (32
    * warp_iters)``; ``branches_per_iter``, material branches per warp
    iteration; ``walk_efficiency``, ``nodes / (32 * warp_nodes)`` (None
    without a walk); and ``identity``, whether ``lane_steps`` equals rays
    plus recursion-depth hits, as it must."""
    rays, rec = int(counters[0]), int(counters[3])
    iters = max(work["warp_iters"], 1)
    return dict(lane_steps=work["lane_steps"], warp_iters=work["warp_iters"],
                efficiency=work["lane_steps"] / (32 * iters),
                branches_per_iter=work["warp_branches"] / iters,
                walk_efficiency=(work["nodes"] / (32 * work["warp_nodes"])
                                 if work["warp_nodes"] else None),
                identity=work["lane_steps"] == rays + rec)


def library() -> ctypes.CDLL:
    """The kernel's library, built from ``csrc/bounce_kernel.cu`` on first
    use (``ops/build.py``)."""
    from zraytrace_tpu_torch.ops.build import load

    return bind(load("bounce_kernel"))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare ``zr_bounce_launch``'s C signature on a build of the kernel
    (this checkout's, or another's of the same interface), and
    ``zr_bounce_launch_blocks``' where the build has it. The guard, and
    the one-block ``zr_bounce_launch`` that forwards to the blocked entry,
    serve only ``probes/mesh_ab.py``'s builds of other checkouts, whose
    sources predate the sample blocks: drop both once it no longer A/Bs
    against such a source."""
    if lib.zr_bounce_launch.argtypes is None:
        head = [_P, _I, _P, _I, _P, _P, _I, _P, _P, _P, _P, _I, _P, _P, _I, _I, _I, _I,
                _I, _I, _U, _I, _I, _I]
        lib.zr_bounce_launch.argtypes = head + [_P, _P, _P]
        lib.zr_bounce_launch.restype = _I
        if hasattr(lib, "zr_bounce_launch_blocks"):
            lib.zr_bounce_launch_blocks.argtypes = head + [_I, _I, _P, _P, _P]
            lib.zr_bounce_launch_blocks.restype = _I
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


def sphere_rows(spheres: torch.Tensor) -> torch.Tensor:
    """The sphere winner's rows, as the kernel makes them once per block
    from ``scene_tables``' spheres (``csrc/bounce_common.cuh``
    ``sphere_row``): ``(S, 4)`` f32 [cx, cy, cz, c.c - r^2], the last term
    in the plain version's operations and order, ``((cx*cx + cy*cy) +
    cz*cz) - r*r``."""
    cx, cy, cz, r = spheres[:, 0], spheres[:, 1], spheres[:, 2], spheres[:, 3]
    return torch.stack([cx, cy, cz, (cx * cx + cy * cy + cz * cz) - r * r], dim=1)


def check_mesh(scene: Scene, tri_flash: TriPlanes | None) -> None:
    """What the kernel's mesh mode takes: the scene's flash planes with
    the const-material ``attrs`` table. A mesh whose materials read an
    image texture has none and raises: ``render()`` routes such a mesh to
    the wavefront with the flash kernel instead (``render.mesh_routing``);
    filling its texels in the mesh mode is ROADMAP.md's Queue 2 item R14."""
    if tri_flash is None or tri_flash.attrs is None:
        raise NotImplementedError(
            "the kernel's mesh mode shades const-material meshes from the flash planes' "
            "attrs table (pack_tri_planes(..., const_materials=True)); render.mesh_routing "
            "sends a mesh with image-textured materials to the wavefront with the flash "
            "kernel instead")
    if tri_flash.n_tris != scene.n_triangles:
        raise ValueError("tri_flash does not hold this scene's triangles")


def bounce_trace(scene: Scene, camera: Camera, pixel_base: torch.Tensor, seed,
                 width, height, spp, max_depth, sample_start=0, pixel_stride=None,
                 n_pixels=None, n_slots: int = 1, tri_flash: TriPlanes | None = None,
                 work: torch.Tensor | None = None, blocks: int = 1):
    """Trace samples ``[sample_start, sample_start + spp)`` of every pixel
    of every lane. Arguments and result are those of
    ``wavefront_trace_reference``: ``(slot_sums (n_slots, N, 3) f32,
    counters (6,) int64)``. ``blocks`` > 1 launches the kernel's sample
    blocks (``render.sample_blocks``' B blocks; each warp of lanes B times,
    one launch) and adds each pixel's B sums in block order, as the plain
    version joins B traces. A scene with triangles needs ``tri_flash``,
    its flash planes with the const-material ``attrs`` table and the BVH
    walk's tables, on a CUDA device (``render.flash_pack_cached``); on the
    CPU they are optional (without them the plain wavefront uses the brute
    force; with them its chunk scan, the contract).
    ``work``, an int64 tensor of ``len(WORK_FIELDS)`` on the card, has the
    work done added to it by a counting build of the kernel (slower; for
    pricing a bound, not for rendering; one block). The plain version
    counts nothing."""
    dev = pixel_base.device
    if dev.type == "cpu":
        return wavefront_trace_reference(
            scene, camera, pixel_base, seed, width, height, spp, max_depth,
            sample_start, pixel_stride, n_pixels, n_slots, tri_flash=tri_flash, blocks=blocks)
    if dev.type != "cuda":
        raise ValueError(f"bounce_trace runs on cpu or cuda tensors, not {dev.type}")

    mesh = scene.n_triangles > 0
    if not (0 if mesh else 1) <= scene.n_spheres <= MAX_SPHERES:
        raise NotImplementedError(
            f"the kernel takes 1..{MAX_SPHERES} spheres (0.. with a mesh), got "
            f"{scene.n_spheres}")
    if mesh:
        check_mesh(scene, tri_flash)
        check_planes(tri_flash, dev)
        check_tables(tri_flash, dev)
    if work is not None and (work.device != dev or work.dtype != torch.int64
                             or work.shape != (len(WORK_FIELDS),)):
        raise ValueError(f"work must be an int64 ({len(WORK_FIELDS)},) tensor on {dev}")
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
    ranges = sample_blocks(spp, blocks)
    n_blocks = len(ranges)
    if work is not None and n_blocks > 1:
        raise ValueError("the counting build traces one sample block")
    warps = -(-n // 32)
    if n_blocks * warps * 32 >= 1 << 31:
        raise ValueError("blocks x lanes must fit in int32")
    base = pixel_base.contiguous()
    if n_blocks > 1:  # each warp of lanes once a block, the blocks in turn; padding idles
        base = torch.cat([base, base.new_full((warps * 32 - n,), n_pix)])
        base = base.view(warps, 1, 32).expand(warps, n_blocks, 32).reshape(-1)
    atlas = scene.atlas.contiguous()
    spheres, mats, cam = scene_tables(scene, camera)

    if mesh:
        mesh_ptrs = (tri_flash.nodes.data_ptr(), tri_flash.rows.data_ptr(),
                     tri_flash.attrs.data_ptr(), tri_flash.root.data_ptr(),
                     tri_flash.nodes.shape[0])
    else:
        mesh_ptrs = (None, None, None, None, 0)

    slot_sums = torch.zeros((n_slots, base.shape[0], 3), dtype=torch.float32, device=dev)
    counters = torch.zeros((N_COUNTERS,), dtype=torch.int64, device=dev)
    lib = library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.zr_bounce_launch_blocks(
            spheres.data_ptr(), spheres.shape[0], mats.data_ptr(), mats.shape[0],
            cam.data_ptr(), atlas.data_ptr(), atlas.shape[2], *mesh_ptrs,
            None if work is None else work.data_ptr(), base.data_ptr(),
            base.shape[0], width, height, sample_start, spp, max_depth, int(seed) & 0xFFFFFFFF,
            stride, n_pix, n_slots, n_blocks, ranges[0][1], slot_sums.data_ptr(),
            counters.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(
            f"bounce kernel launch failed: {lib.zr_error_string(err).decode()}")
    count("launch.bounce")
    if mesh:
        count("launch.bounce_mesh")
    if n_blocks == 1:
        return slot_sums, counters
    per_block = slot_sums.view(n_slots, warps, n_blocks, 32, 3)
    sums, _ = add_blocks([(per_block[:, :, 0], counters)]
                         + [(per_block[:, :, b], None) for b in range(1, n_blocks)])
    return sums.reshape(n_slots, warps * 32, 3)[:, :n].contiguous(), counters
