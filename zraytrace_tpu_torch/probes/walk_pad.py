"""How far must the BVH walk's node boxes be dilated so that the walk
drops no hit that the chunk scan finds?

A count on the host, through the walk's plain twin (``ops/mesh_bvh.py``
``bvh_winner_plain``, the kernel's arithmetic) against the chunk scan
(``flash_intersect_plain``, the contract); no time is measured. Leaf
boxes are tight, and flat ones occur: on a floor of coplanar axis-aligned
triangles, rays at grazing incidence are the hard case, since there the
triangle test accepts crossings a little outside a triangle, and so
outside its tight leaf box. For each pad (a share of each box's extent
plus a share of its largest coordinate magnitude, as
``mesh_bvh.node_table`` widens boxes, or the margin kernel's half-extent
plus 1e-3, ``flash_intersect.dilated_bounds``) it prints, per case:

- ``dropped``: rays whose walk winner comes after the chunk scan's in
  (t, packed position), or that the walk misses: hits the cull lost;
- ``kept``: rays whose walk winner comes before: real hits that the chunk
  scan's own undilated chunk boxes dropped;
- node slab tests and triangle tests per ray, the pad's cost.

Cases: ``floor_*``, three floors of 8 x 8 square cells (two triangles
each) at grazing rays (angles 10^-6.3 to 10^-1 rad, aimed at grid lines
and corners, ``grazing_rays``); ``teapot``, the rays scene 3's plain
wavefront gives the winner at 40x30, 2 spp, depth 8.

    python -m zraytrace_tpu_torch.probes.walk_pad [--rays N]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from zraytrace_tpu_torch import vecmath as vm
from zraytrace_tpu_torch.geometry.bvh import build_tri_bvh
from zraytrace_tpu_torch.ops import flash_intersect as fi
from zraytrace_tpu_torch.ops import mesh_bvh as mb

T_MIN = 1e-3
# name -> (height, first grid line, cell size)
FLOORS = {"floor_y0": (0.0, -4.0, 1.0), "floor_y0.3": (0.3, -4.1, 0.7),
          "floor_far": (-2.33, 100.0, 0.25)}
# (share of extent, share of magnitude, or None for dilated_bounds)
PADS = ((0.0, 0.0), (2.0 ** -8, 2.0 ** -12), (2.0 ** -6, 2.0 ** -12),
        (mb.PAD_EXTENT, mb.PAD_MAGNITUDE), None)


def floor(y0: float, x0: float, cell: float, n: int = 8):
    """An ``n`` x ``n`` grid of square cells at height ``y0`` from ``(x0,
    x0)``, two triangles a cell, facing +y: ``((a, b, c), grid lines)``."""
    xs = x0 + cell * np.arange(n + 1, dtype=np.float64)
    a, b, c = [], [], []
    for i in range(n):
        for j in range(n):
            u0, u1, w0, w1 = xs[i], xs[i + 1], xs[j], xs[j + 1]
            a += [(u0, y0, w0), (u1, y0, w1)]
            b += [(u0, y0, w1), (u1, y0, w0)]
            c += [(u1, y0, w0), (u0, y0, w1)]
    return tuple(torch.tensor(np.array(x), dtype=torch.float32) for x in (a, b, c)), xs


def grazing_rays(xs, y0: float, n: int, g: np.random.Generator):
    """Rays down onto the floor at angles 10^-6.3 to 10^-1 rad, aimed at
    grid lines (a third), at points on lines crossed with random points,
    and at grid corners: ``(o, d)``."""
    k = n // 3
    tx = np.concatenate([g.choice(xs, k), g.uniform(xs[0], xs[-1], k), g.choice(xs, n - 2 * k)])
    tz = np.concatenate([g.uniform(xs[0], xs[-1], k), g.choice(xs, k), g.choice(xs, n - 2 * k)])
    th = 10.0 ** g.uniform(-6.3, -1.0, n)
    ph = g.uniform(0.0, 2.0 * np.pi, n)
    d = np.stack([np.cos(th) * np.cos(ph), -np.sin(th), np.cos(th) * np.sin(ph)], 1)
    length = g.uniform(0.5, 3.0, n) * (xs[-1] - xs[0])
    o = np.stack([tx, np.full(n, y0), tz], 1) - d * length[:, None]
    return (torch.tensor(o, dtype=torch.float32),
            vm.normalize(torch.tensor(d, dtype=torch.float32)))


def packed_planes(a, b, c):
    """BVH-ordered planes with packed ids and the walk's tables, and the
    BVH."""
    bvh = build_tri_bvh(a, b, c)
    planes = fi.pack_tri_planes(a, b, c, order=bvh.prim_order, tri_mat=torch.zeros(a.shape[0]),
                                const_materials=True)
    return mb.bvh_tables(planes, bvh), bvh


def with_pad(planes, bvh, pad):
    """The planes with node boxes widened by ``pad`` instead."""
    lo, hi = bvh.node_min, bvh.node_max
    if pad is None:
        boxes = fi.dilated_bounds(torch.cat([lo, hi, lo.new_zeros((lo.shape[0], 2))], 1))[:, :6]
    else:
        mag = torch.maximum(lo.abs(), hi.abs()).amax(1, keepdim=True)
        widen = pad[0] * (hi - lo) + pad[1] * mag
        boxes = torch.cat([lo - widen, hi + widen], 1)
    return planes._replace(nodes=torch.cat([boxes, planes.nodes[:, 6:8]], 1).contiguous())


def compare(planes, o, d, t_init=None) -> dict:
    """Walk against chunk scan on these rays: ``dropped``, ``kept`` and the
    walk's work per ray."""
    (wt, wi, wh, _), work = mb.bvh_winner_plain(planes, o, d, T_MIN, t_init)
    st, si, sh, _ = fi.flash_intersect_plain(planes, o, d, T_MIN, t_init)
    earlier = wh & (~sh | (wt < st) | ((wt == st) & (wi < si)))
    differ = (wt != st) | (wi != si) | (wh != sh)
    n = o.shape[0]
    return dict(rays=n, hits=int(sh.sum()), dropped=int((differ & ~earlier).sum()),
                kept=int((differ & earlier).sum()), nodes=work["nodes"] / n, tris=work["tris"] / n)


def scene_rays(index: int = 3, w: int = 40, h: int = 30, spp: int = 2, depth: int = 8):
    """Scene ``index``'s packed planes and BVH, and the rays its plain
    wavefront gives the triangle winner that reach the mesh's root box:
    ``(planes, bvh, o, d, t_sphere)``."""
    from zraytrace_tpu_torch.kernel_inputs import recorded_calls
    from zraytrace_tpu_torch.render import wavefront_trace
    from zraytrace_tpu_torch.scenes import build_scene

    built = build_scene(index, "cpu")
    s = built.scene
    planes, bvh = packed_planes(s.tri_a, s.tri_b, s.tri_c)
    calls = {}
    with recorded_calls(calls):
        n = w * h
        wavefront_trace(s, built.camera, torch.arange(n, dtype=torch.int32), 42, w, h, spp, depth,
                        0, n, n, 1, tri_flash=planes)
    recs = calls["flash_intersect"]
    o, d, ts = (torch.cat([getattr(c, k) for c in recs]) for k in ("o", "d", "x"))
    near, far = fi._slab(planes.root[0:3], planes.root[3:6], o, fi._inv_dir(d))
    root = (near <= far) & (far > T_MIN) & (near <= ts)
    return planes, bvh, o[root], d[root], ts[root]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rays", type=int, default=60000, help="grazing rays per floor")
    args = ap.parse_args(argv)
    torch.manual_seed(0)
    cases = []
    for i, (name, (y0, x0, cell)) in enumerate(FLOORS.items()):
        (a, b, c), xs = floor(y0, x0, cell)
        planes, bvh = packed_planes(a, b, c)
        cases.append((name, planes, bvh, *grazing_rays(xs, np.float32(y0), args.rays,
                                                       np.random.default_rng(i + 1)), None))
    cases.append(("teapot", *scene_rays(3)))
    for name, planes, bvh, o, d, t_init in cases:
        for pad in PADS:
            r = compare(with_pad(planes, bvh, pad), o, d, t_init)
            label = "dilated_bounds" if pad is None else f"extent {pad[0]:g}, magnitude {pad[1]:g}"
            print(f"[pad] {name} ({label}): {r['rays']} rays, {r['hits']} chunk-scan hits; "
                  f"dropped {r['dropped']}, kept {r['kept']}; {r['nodes']:.3f} node slab tests "
                  f"and {r['tris']:.3f} triangle tests per ray (host count)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
