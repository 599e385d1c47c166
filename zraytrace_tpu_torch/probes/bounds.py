"""The least time the card could take for a kernel's work: the pricing
``chip_smoke.py`` and the A/B scripts (``probes/mesh_ab.py``) share.

A bound is the larger of the bytes the function must move (each input
read once, each output written once) over the card's memory rate and its
operations over the card's FP32 rate (H100 SXM, NVIDIA's data sheet), with
the operations counted from the code (adds, multiplies, divisions, square
roots and negations; compares and selects not counted) for the work this
run's data needs: each stage is priced by the count that reaches it, from
the events the counters report and the work counts of each kernel's
counting build.
"""

from __future__ import annotations

__all__ = ["PEAK_FLOPS", "PEAK_BYTES", "RAY_SETUP_FLOPS", "bound", "nbytes", "tri_flops",
           "walk_flops", "margin_flops", "bounce_flops"]

# H100 SXM peaks (NVIDIA's data sheet): FP32 outside the tensor cores, HBM3.
PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# FP32 operations per event or stage, counted from csrc/bounce_kernel.cu,
# csrc/tri_winner.cuh and csrc/tri_bvh.cuh
CAMERA_FLOPS = 34  # jitter scale 4, viewport uv 6, direction 15, normalize 9
SEGMENT_FLOPS = 10  # o.d and |o|^2
SPHERE_ROW_FLOPS = 7  # once per sphere: c.c 5, r^2 1, their difference 1
SPHERE_TEST_FLOPS = 16  # every sphere test: half-b 6, c 8 (c.c - r^2 made), discriminant 2
SPHERE_ROOT_FLOPS = 5  # discriminant > 0: sqrt 1, two roots 4
MISS_FLOPS = 18  # sky gradient 9, weighted sum 9
HIT_FLOPS = 57  # point 6, facing 8, reflect 12, scatter 18, normalize 10, albedo 3
SPHERE_NORMAL_FLOPS = 6  # a sphere hit's normal (a triangle hit reads its attrs row)
RAY_SETUP_FLOPS = 12  # 1/d 3, o x d 9
SLAB_FLOPS = 12  # 6 subtractions, 6 multiplications
DET_FLOPS = 6  # every triangle test: d.fn 5, negation 1
T_FLOPS = 8  # det passed: 1/det 1, o.fn 5, - a.fn 1, * 1/det 1
U_FLOPS = 12  # t passed: (o x d).e2 5, d.(e2 x a) 5, - 1, * 1/det 1
V_FLOPS = 14  # u passed: (o x d).e1 5, d.(e1 x a) 5, - 1, negation 1, * 1/det 1, u + v 1
# csrc/flash_margins.cu: per ray, the set-up and the cap and guards 3;
# past t > t_min, u 12, v 13 and 1 - u - v 2
MARGIN_RAY_FLOPS = RAY_SETUP_FLOPS + 3
MARGIN_T_FLOPS = 27


def bound(flops: float, nbytes: float, int_ops: float = 0) -> tuple[float, str]:
    """(bound_ms, bound_by) for the given work. INT32 operations are priced
    at the FP32 rate, summed with the FP32 ones: an SM dispatches at most 128
    lanes of instructions per clock, FP32 or INT32 alike (IMAD, the integer
    multiply-add, runs on the FMA pipe; LOP3, SHF and IADD3 on the integer
    pipe), and one instruction does at most two operations. The integer
    pipe's own 64 lanes per clock is no lower bound: the PCG4D probe runs
    faster than its operations priced at that rate."""
    t_ops = (flops + int_ops) / PEAK_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def tri_flops(w: dict) -> int:
    """FP32 operations of the flash winner's chunk scan for work counts
    ``w``: a slab test per chunk box tried, then per chunk visited 128
    triangle tests (the padding lanes of a partial last chunk included),
    each stage priced by the tests that reach it."""
    return (w["slab"] * SLAB_FLOPS + 128 * w["visits"] * DET_FLOPS + w["det"] * T_FLOPS
            + w["t"] * U_FLOPS + w["u"] * V_FLOPS)


def walk_flops(w: dict) -> int:
    """FP32 operations of the BVH walk (csrc/tri_bvh.cuh) for work counts
    ``w``: a slab test per node tried, then each triangle test of an
    entered leaf, each stage priced by the tests that reach it."""
    return (w["nodes"] * SLAB_FLOPS + w["tris"] * DET_FLOPS + w["det"] * T_FLOPS
            + w["t"] * U_FLOPS + w["u"] * V_FLOPS)


def margin_flops(w: dict, n_rays: int) -> int:
    """FP32 operations of the margin selection for work counts ``w`` on
    ``n_rays`` rays, each stage priced by the tests that reach it (the
    boxes' dilation, once per box, not counted)."""
    return (n_rays * MARGIN_RAY_FLOPS + w["slab"] * SLAB_FLOPS + 128 * w["visits"] * DET_FLOPS
            + w["det"] * T_FLOPS + w["t"] * MARGIN_T_FLOPS)


def bounce_flops(c, n_spheres: int, w: dict, mesh: bool) -> int:
    """FP32 operations of the bounce kernel for counters ``c`` and work
    counts ``w``: a camera ray per sample, the sphere tests of every
    segment (the roots only where the discriminant is positive), the sky
    on a miss, scatter on a hit (a sphere hit's normal only for spheres)
    and, in mesh mode, the ray set-up and root-box test of every segment
    and the triangle winner's work: the BVH walk's (``walk_flops``), or,
    for the work counts of a chunk-scan build, the chunk scan's
    (``tri_flops``). A sphere's c.c - r^2 is priced once, as the kernel's
    prologue makes it, so a build that made it in every test is priced on
    the same yardstick."""
    rays, refl, bg, _, samples, _ = c
    flops = (samples * CAMERA_FLOPS + n_spheres * SPHERE_ROW_FLOPS
             + rays * (SEGMENT_FLOPS + n_spheres * SPHERE_TEST_FLOPS)
             + w["disc"] * SPHERE_ROOT_FLOPS + bg * MISS_FLOPS + (rays - bg) * HIT_FLOPS
             + (rays - bg - w["tri_hits"]) * SPHERE_NORMAL_FLOPS)
    if mesh:
        flops += (rays * (RAY_SETUP_FLOPS + SLAB_FLOPS)
                  + (walk_flops(w) if "nodes" in w else tri_flops(w)))
    return flops
