"""Wavefront path-tracing engine and the ``render()`` entry point.

Counterpart of ``zraytrace_tpu/render.py`` for sphere and mesh scenes.
The plain wavefront here (``wavefront_trace``) defines the event-counter
semantics, exactly as the JAX engine does: one lane per pixel slot, all
lanes advanced one bounce per iteration, a lane regenerating its next
camera sample as soon as a path ends. It is the CPU engine and the
reference the CUDA bounce kernel (``ops/bounce_kernel.py``) is held to.

Radiance identity (no emitters; the sky gradient is the only light,
raytrace.zig:53-58): a path contributes ``prod(attenuations) * sky(dir)``
when it escapes, else black (absorbed, or depth exhausted).

Counters are one int64 tensor of shape ``(6,)`` — rays, reflections,
background hits, recursion-depth hits, samples, wavefront iterations —
in place of the JAX package's two-limb uint32 pairs.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import TYPE_CHECKING, NamedTuple

import torch

from zraytrace_tpu_torch import camera as cam
from zraytrace_tpu_torch import materials as mat
from zraytrace_tpu_torch import rng as zrng
from zraytrace_tpu_torch import vecmath as vm
from zraytrace_tpu_torch.config import T_MIN, RenderParams
from zraytrace_tpu_torch.geometry.sphere import (
    BIG,
    intersect_spheres,
    intersect_spheres_fused,
    sphere_attributes,
    sphere_surface,
)
from zraytrace_tpu_torch.geometry.triangle import intersect_triangles, triangle_surface
from zraytrace_tpu_torch.profiling import count, span
from zraytrace_tpu_torch.scene import Scene, mesh_materials_const

if TYPE_CHECKING:
    from zraytrace_tpu_torch.ops.flash_intersect import TriPlanes

# Counter slots, mirroring Progress (raytrace.zig:20-34), plus iteration
# telemetry: the number of lockstep wavefront steps, which equals the
# largest number of loop steps any one lane took.
N_COUNTERS = 6
C_RAYS, C_REFLECTIONS, C_BACKGROUND, C_RECURSION, C_SAMPLES, C_ITERS = range(N_COUNTERS)

# The fused sphere winner is written for the reference's scene sizes.
MAX_SPHERES = 32


@dataclasses.dataclass
class RenderStats:
    """Totals as published by the reference (raytrace.zig:188-201).

    ``render()`` sums its spans (``profiling``) into the seconds:
    ``preprocess_seconds`` is ``render.prepare`` and ``render.route``;
    ``render_seconds`` is ``render.launch`` and ``render.wait``, which ends
    when the counters reached the host (the device has finished);
    ``transfer_seconds`` is ``render.fetch`` and ``render.divide``, the
    image's fetch and decode.
    """

    rays: int = 0
    reflections: int = 0
    background_hits: int = 0
    recursion_depth_hits: int = 0
    samples: int = 0
    pixels: int = 0
    wavefront_iterations: int = 0
    preprocess_seconds: float = 0.0
    render_seconds: float = 0.0
    transfer_seconds: float = 0.0

    @property
    def rays_per_second(self) -> float:
        return self.rays / self.render_seconds if self.render_seconds else 0.0

    @property
    def pixels_per_second(self) -> float:
        return self.pixels / self.render_seconds if self.render_seconds else 0.0


def background_color(d: torch.Tensor) -> torch.Tensor:
    """Sky gradient for escaping rays (raytrace.zig:53-58). ``d`` unit."""
    t = 0.5 * (d[..., 1] + 1.0)
    white = torch.tensor([1.0, 1.0, 1.0], dtype=torch.float32, device=d.device)
    blue = torch.tensor([0.5, 0.7, 1.0], dtype=torch.float32, device=d.device)
    return (1.0 - t)[..., None] * white + t[..., None] * blue


def trace_closest(scene: Scene, o, d, t_min=T_MIN, t_max=BIG, tri_flash=None):
    """Closest-hit query over all primitives (the JAX ``trace_closest``).
    Returns dict with: hit (N,), t, point (N,3), normal (N,3) flipped
    against the ray, front_face (N,), uv (N,2), mat_id (N,).

    Sphere-only scenes of at most ``MAX_SPHERES`` spheres take the fused
    running winner. Otherwise spheres and triangles are intersected
    separately and merged by a strict ``tt < ts``: spheres keep exact ties,
    as every reference scene inserts spheres before its mesh
    (raytrace.zig:75-81). Triangles come from the brute force, or, given
    ``tri_flash`` planes, from the flash winner seeded with the sphere
    distance (``ops/flash_intersect.py``: the CUDA kernel for tensors on
    the card, its plain version on the CPU); with its ``attrs`` table the
    hit normal and material are one row of it.
    """
    n = o.shape[0]
    if scene.n_triangles == 0 and 0 < scene.n_spheres <= MAX_SPHERES:
        fs = intersect_spheres_fused(o, d, scene.sph_center, scene.sph_radius,
                                     scene.sph_mat, t_min, t_max)
        hit = fs["hit"]
        # attributes at a safe t on miss lanes (their values are discarded)
        t_attr = torch.where(hit, fs["t"], 1.0)
        point, outward, uv = sphere_attributes(o, d, t_attr, fs["center"], fs["radius"])
        front_face = vm.dot(d, outward) <= 0.0  # hit_record.zig:28-41
        normal = torch.where(front_face[:, None], outward, -outward)
        return dict(hit=hit, t=fs["t"], point=point, normal=normal,
                    front_face=front_face, uv=uv, mat_id=fs["mat_id"])

    from zraytrace_tpu_torch.ops.flash_intersect import flash_intersect_triangles

    zeros3 = torch.zeros_like(o)
    if scene.n_spheres > 0:
        ts, si, _ = intersect_spheres(o, d, scene.sph_center, scene.sph_radius, t_min, t_max)
    else:
        ts = torch.full((n,), BIG, dtype=torch.float32, device=o.device)
        si = torch.zeros((n,), dtype=torch.int32, device=o.device)
    flash_attrs = False
    if tri_flash is not None and scene.n_triangles > 0:
        tt, ti, _, uv_t = flash_intersect_triangles(tri_flash, o, d, t_min, t_init=ts)
        flash_attrs = tri_flash.attrs is not None
    else:
        tt, ti, _, uv_t = intersect_triangles(o, d, scene.tri_a, scene.tri_b, scene.tri_c,
                                              t_min, t_max)
    use_tri = tt < ts
    t = torch.where(use_tri, tt, ts)
    hit = t < BIG
    t_attr = torch.where(hit, t, 1.0)

    if scene.n_spheres > 0:
        p_s, n_s, uv_s = sphere_surface(o, d, t_attr, si, scene.sph_center, scene.sph_radius)
        mat_s = scene.sph_mat[si.long()]
    else:
        p_s, n_s = zeros3, zeros3
        uv_s = torch.zeros((n, 2), dtype=torch.float32, device=o.device)
        mat_s = torch.zeros((n,), dtype=torch.int32, device=o.device)
    if scene.n_triangles > 0:
        if flash_attrs:
            at = tri_flash.attrs[ti.long()]
            p_t, n_t = vm.ray_at(o, d, t_attr), at[:, :3]
            mat_t = at[:, 3].to(torch.int32)
        else:
            p_t, n_t = triangle_surface(o, d, t_attr, ti, scene.tri_a, scene.tri_b, scene.tri_c)
            mat_t = scene.tri_mat[ti.long()]
    else:
        p_t, n_t = zeros3, zeros3
        mat_t = torch.zeros((n,), dtype=torch.int32, device=o.device)

    u3 = use_tri[:, None]
    point = torch.where(u3, p_t, p_s)
    outward = torch.where(u3, n_t, n_s)
    uv = torch.where(u3, uv_t, uv_s)
    mat_id = torch.where(use_tri, mat_t, mat_s)
    front_face = vm.dot(d, outward) <= 0.0  # hit_record.zig:28-41
    normal = torch.where(front_face[:, None], outward, -outward)
    return dict(hit=hit, t=t, point=point, normal=normal,
                front_face=front_face, uv=uv, mat_id=mat_id)


def camera_rays(camera: cam.Camera, seed, pixel_ids, sample_idx, width, height):
    """Jittered primary rays for ``(pixel, sample)`` pairs
    (raytrace.zig:174-175), keyed on the camera stream."""
    j = zrng.uniform4(seed, pixel_ids, sample_idx, 0, zrng.STREAM_CAMERA)
    px = (pixel_ids % width).to(torch.float32)
    py = (pixel_ids // width).to(torch.float32)
    u, v = cam.pixel_uv(px, py, j[:, 0], j[:, 1], float(width), float(height))
    return cam.get_rays(camera, u, v)


def sample_blocks(spp: int, blocks: int) -> list[tuple[int, int]]:
    """``spp`` samples cut into at most ``blocks`` contiguous blocks, as
    ``(offset, count)``: each ``q = ceil(spp / min(blocks, spp))`` long
    but the last, which holds the rest; no block is empty."""
    if spp < 1 or blocks < 1:
        raise ValueError(f"need spp >= 1 and blocks >= 1, got {spp} and {blocks}")
    q = -(-spp // min(blocks, spp))
    return [(off, min(q, spp - off)) for off in range(0, spp, q)]


def add_blocks(parts):
    """Traces of the same lanes over consecutive sample blocks,
    ``[(slot_sums, counters)]``, as one: each pixel's block sums added in
    block order (``((s0 + s1) + s2) + ...``), the events summed, the
    iterations the longest block's. A part whose counters are None (a
    block of a launch that counted all its blocks at once) adds only its
    sums."""
    sums, counters = parts[0]
    for s, c in parts[1:]:
        sums = sums + s
        if c is not None:
            counters = torch.cat([counters[:C_ITERS] + c[:C_ITERS],
                                  torch.maximum(counters[C_ITERS:], c[C_ITERS:])])
    return sums, counters


def wavefront_trace(scene: Scene, camera: cam.Camera, pixel_base: torch.Tensor,
                    seed, width, height, spp, max_depth, sample_start=0,
                    pixel_stride=None, n_pixels=None, n_slots: int = 1, tri_flash=None,
                    blocks: int = 1):
    """Trace samples ``[sample_start, sample_start + spp)`` of the pixels
    of each lane, the plain PyTorch way. ``tri_flash`` (packed planes)
    routes triangles through the flash winner, else the brute force
    (``trace_closest``). On the card the flash winner is its CUDA kernel,
    as the JAX package's XLA wavefront calls its Pallas flash kernel.

    Lane ``i`` processes pixels ``pixel_base[i] + k * pixel_stride`` for
    ``k in [0, n_slots)`` (stopping at the first id >= ``n_pixels``), one
    sample after another. Runs on the device of ``pixel_base``.

    ``blocks`` > 1: the samples cut by ``sample_blocks``, one trace of the
    lanes a block, joined by ``add_blocks`` (the bounce kernel's sample
    blocks, which run every block's lanes in one launch).

    Returns ``(slot_sums (n_slots, N, 3) f32, counters (6,) int64)``.
    """
    if blocks > 1:
        return add_blocks([
            wavefront_trace(scene, camera, pixel_base, seed, width, height, count, max_depth,
                            sample_start + off, pixel_stride, n_pixels, n_slots, tri_flash)
            for off, count in sample_blocks(spp, blocks)])
    dev = pixel_base.device
    n = pixel_base.shape[0]
    base = pixel_base.to(torch.int32)
    stride = n if pixel_stride is None else int(pixel_stride)
    n_pix = width * height if n_pixels is None else int(n_pixels)
    sample_end = sample_start + spp
    i32 = dict(dtype=torch.int32, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)

    def lane_pixel(slot):
        return base + slot * stride

    def rays_for(slot, sample_idx):
        return camera_rays(camera, seed, lane_pixel(slot), sample_idx, width, height)

    slot = torch.zeros((n,), **i32)
    sample_idx = torch.full((n,), sample_start, **i32)
    o, d = rays_for(slot, sample_idx)
    throughput = torch.ones((n, 3), **f32)
    acc = torch.zeros((n, 3), **f32)  # current pixel's sample sum
    path_depth = torch.zeros((n,), **i32)
    slot_sums = torch.zeros((n_slots, n, 3), **f32)
    counters = torch.zeros((N_COUNTERS,), dtype=torch.int64, device=dev)
    lanes = torch.arange(n, device=dev)

    def lane_alive(slot):
        return (slot < n_slots) & (lane_pixel(slot) < n_pix)

    while bool(lane_alive(slot).any()):
        pixel_ids = lane_pixel(slot)
        active = lane_alive(slot) & (sample_idx < sample_end)
        # depth check before tracing, like raytrace.zig:64-67
        exhausted = active & (path_depth >= max_depth)
        processing = active & ~exhausted

        h = trace_closest(scene, o, d, tri_flash=tri_flash)
        rnd = zrng.uniform4(seed, pixel_ids, sample_idx, path_depth, zrng.STREAM_SCATTER)
        new_dir, atten, absorbed = mat.scatter(
            scene, d, h["normal"], h["front_face"], h["uv"], h["mat_id"], rnd)

        miss = processing & ~h["hit"]
        absorb_end = processing & h["hit"] & absorbed
        scattered = processing & h["hit"] & ~absorbed
        path_done = miss | absorb_end | exhausted

        # only escaping paths carry radiance: the sky is the only light
        radiance = torch.where(miss[:, None], throughput * background_color(d), 0.0)
        acc = acc + radiance

        counters += torch.stack([
            processing.sum(), scattered.sum(), miss.sum(), exhausted.sum(),
            path_done.sum(), torch.ones((), dtype=torch.int64, device=dev)])

        sc3 = scattered[:, None]
        throughput = torch.where(sc3, throughput * atten, throughput)
        o = torch.where(sc3, h["point"], o)
        d = torch.where(sc3, new_dir, d)
        path_depth = path_depth + scattered.to(torch.int32)

        # a finished pixel commits its sum to its slot; the lane moves on
        sample_idx = sample_idx + path_done.to(torch.int32)
        finished = path_done & (sample_idx >= sample_end)
        slot_sums.index_put_((slot[finished].long(), lanes[finished]),
                             acc[finished], accumulate=True)
        acc = torch.where(finished[:, None], 0.0, acc)
        slot = slot + finished.to(torch.int32)
        sample_idx = torch.where(finished, sample_start, sample_idx)

        # regenerate the next camera sample where a path just ended
        o_new, d_new = rays_for(slot, sample_idx)
        pd3 = path_done[:, None]
        o = torch.where(pd3, o_new, o)
        d = torch.where(pd3, d_new, d)
        throughput = torch.where(pd3, 1.0, throughput)
        path_depth = torch.where(path_done, 0, path_depth)

    return slot_sums, counters


_FLASH_MEMO: dict = {}


def flash_pack_cached(scene: Scene):
    """BVH-ordered flash planes of a scene's mesh, with the BVH walk's
    tables (``ops/mesh_bvh.py``), on the scene's device, memoized by
    content (``flash_pack_cached``, ``zraytrace_tpu/render.py:542``): the
    BVH build and the packing are scene preprocessing, done once per mesh."""
    from zraytrace_tpu_torch.geometry.bvh import build_tri_bvh
    from zraytrace_tpu_torch.ops.flash_intersect import pack_tri_planes
    from zraytrace_tpu_torch.ops.mesh_bvh import bvh_tables

    const = mesh_materials_const(scene)
    h = hashlib.sha256()
    for a in (scene.tri_a, scene.tri_b, scene.tri_c, scene.tri_mat):
        data = a.detach().cpu().contiguous().numpy().tobytes()
        h.update(data)
        count("flash_memo.hashed_bytes", len(data))
    h.update(b"c" if const else b"n")
    key = (h.hexdigest(), str(scene.tri_a.device))
    planes = _FLASH_MEMO.get(key)
    count("flash_memo.miss" if planes is None else "flash_memo.hit")
    if planes is None:
        a, b, c, m = (x.cpu() for x in (scene.tri_a, scene.tri_b, scene.tri_c, scene.tri_mat))
        bvh = build_tri_bvh(a, b, c)
        planes = pack_tri_planes(a, b, c, order=bvh.prim_order, tri_mat=m,
                                 const_materials=const)
        planes = bvh_tables(planes, bvh).to(scene.tri_a.device)
        while len(_FLASH_MEMO) >= 4:
            _FLASH_MEMO.pop(next(iter(_FLASH_MEMO)))
        _FLASH_MEMO[key] = planes
    return planes


class MeshRoute(NamedTuple):
    """The engine ``render()`` traces a scene's lanes with, as
    ``mesh_routing`` resolves it: ``kernel`` True for ``bounce_trace``
    (the bounce kernel on the card, in mesh mode for a mesh scene; the
    plain wavefront on the CPU), False for ``wavefront_trace`` with the
    flash winner over ``tri_flash`` (on the card the flash kernel, every
    bounce). ``tri_flash``: the scene's BVH-ordered flash planes, or None
    (no mesh, or the CPU, where the plain wavefront takes the brute
    force)."""

    kernel: bool
    tri_flash: TriPlanes | None


def mesh_routing(scene: Scene, device) -> MeshRoute:
    """The route of ``render()``, ``render_checkpointed`` and
    ``sharded_sums`` (``mesh_routing``, ``zraytrace_tpu/render.py:576``),
    decided from the scene's materials before any launch:

    - no mesh: the bounce kernel in sphere mode;
    - on a CUDA device, a mesh whose materials are all constant colours:
      the bounce kernel's mesh mode, which shades from the planes'
      ``attrs`` table;
    - on a CUDA device, a mesh whose materials read an image texture:
      those planes have no ``attrs`` table, which the mesh mode needs, so
      the wavefront with the flash winner, whose uv the texel fetch
      reads, as the JAX package sends such a mesh to its XLA wavefront
      and the Pallas flash kernel;
    - on the CPU: the plain wavefront with the brute force, as the JAX
      package does off the TPU.
    """
    if scene.n_triangles == 0 or torch.device(device).type != "cuda":
        return MeshRoute(True, None)
    planes = flash_pack_cached(scene)
    return MeshRoute(planes.attrs is not None, planes)


def trace_route(route: MeshRoute, scene: Scene, camera: cam.Camera, pixel_base, seed, width,
                height, spp, max_depth, sample_start=0, pixel_stride=None, n_pixels=None,
                n_slots: int = 1, blocks: int = 1):
    """Trace lanes as ``wavefront_trace`` does, through ``route``'s
    engine: ``(slot_sums (n_slots, N, 3) f32, counters (6,) int64)``.
    ``blocks`` > 1: the samples in blocks, as ``wavefront_trace`` cuts and
    joins them (on the card the bounce kernel runs them in one launch)."""
    args = (scene, camera, pixel_base, seed, width, height, spp, max_depth, sample_start,
            pixel_stride, n_pixels, n_slots)
    if route.kernel:
        from zraytrace_tpu_torch.ops.bounce_kernel import bounce_trace

        return bounce_trace(*args, tri_flash=route.tri_flash, blocks=blocks)
    return wavefront_trace(*args, tri_flash=route.tri_flash, blocks=blocks)


class Lanes(NamedTuple):
    """``render()``'s layout of a ``width`` x ``height`` image on the
    wavefront's lanes: lane i starts at pixel ``base[i] = i``, and pixel p
    lives at (slot ``p // n_lanes``, lane ``p % n_lanes``)."""

    width: int
    height: int
    n_lanes: int
    n_slots: int
    base: torch.Tensor

    @property
    def n_pixels(self) -> int:
        return self.width * self.height


def lanes(width: int, height: int, max_wavefront: int, device) -> Lanes:
    """``min(n_pixels, max_wavefront)`` lanes on ``device``, as many
    slots as it takes to cover the image."""
    n_pixels = width * height
    n_lanes = min(n_pixels, max_wavefront)
    return Lanes(width, height, n_lanes, math.ceil(n_pixels / n_lanes),
                 torch.arange(n_lanes, dtype=torch.int32, device=device))


def trace_lanes(route: MeshRoute, scene: Scene, camera: cam.Camera, lay: Lanes, seed, spp,
                max_depth, sample_start=0):
    """Samples ``[sample_start, sample_start + spp)`` of every pixel of
    ``lay`` through ``route``'s engine: ``trace_route``'s result."""
    return trace_route(route, scene, camera, lay.base, seed, lay.width, lay.height, spp,
                       max_depth, sample_start, lay.n_lanes, lay.n_pixels, lay.n_slots)


def fetch_sums(sums: torch.Tensor, lay: Lanes) -> torch.Tensor:
    """``trace_lanes``' sums of ``lay``'s pixels on the CPU, ``(n_pixels,
    3)`` f32."""
    return sums.reshape(lay.n_slots * lay.n_lanes, 3)[:lay.n_pixels].cpu()


def decode(flat: torch.Tensor, lay: Lanes, spp: int) -> torch.Tensor:
    """The image of fetched sums (``fetch_sums``) over ``spp`` samples:
    ``(H, W, 3)`` f32 on the CPU, row 0 the bottom."""
    return (flat / spp).reshape(lay.height, lay.width, 3)


def render(scene: Scene, camera: cam.Camera, params: RenderParams, device="cuda"):
    """Render a full image on ``device``. Returns ``(image (H, W, 3) f32
    CPU tensor, RenderStats)``.

    Row 0 of the image is the *bottom* (the PNG writer flips). On a CUDA
    device the bounce loop runs in the CUDA kernel (mesh scenes in its
    mesh mode, over the BVH walk's tables made once per mesh; a mesh with
    image-textured materials in the wavefront, whose every bounce launches
    the flash kernel: ``mesh_routing``); on the CPU in the plain
    wavefront, only when the caller asks for it. Without a card the
    default device raises. ``params.bvh`` changes nothing, as in the JAX
    package at its default ``bvh_min_triangles``: every mesh route here
    already walks a BVH or its BVH-ordered chunks.
    """
    from zraytrace_tpu_torch.ops.bounce_kernel import library

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("render(device='cuda') but no CUDA device is available")
    spp = params.samples_per_pixel
    with span("render.render"):
        with span("render.prepare") as prepare:
            if device.type == "cuda":
                library()  # the first use builds the kernel: set-up, not render time
            lay = lanes(params.width, params.height, params.max_wavefront, device)
            scene = scene.to(device)
            camera = camera.to(device)
        with span("render.route") as routing:
            route = mesh_routing(scene, device)
        with span("render.launch") as launch:
            sums, counters = trace_lanes(route, scene, camera, lay, params.seed, spp,
                                         params.max_depth)
        with span("render.wait") as wait:
            totals = counters.cpu().tolist()  # waits for the device
        with span("render.fetch") as fetch:
            flat = fetch_sums(sums, lay)
        with span("render.divide") as divide:
            image = decode(flat, lay, spp)

    rays, refl, bg, rec, samples, iters = totals
    stats = RenderStats(
        rays=rays, reflections=refl, background_hits=bg,
        recursion_depth_hits=rec, samples=samples, pixels=lay.n_pixels,
        wavefront_iterations=iters, preprocess_seconds=prepare.seconds + routing.seconds,
        render_seconds=launch.seconds + wait.seconds,
        transfer_seconds=fetch.seconds + divide.seconds)
    return image, stats
