"""The BVH walk of the bounce kernel's mesh mode on the CPU: the port's
node arrays against the JAX package's build, the walk's plain twin
``bvh_winner_plain`` (``ops/mesh_bvh.py``) against the chunk scan it
replaces (``flash_intersect_plain``, the contract) and against the JAX
traversal ``bvh_closest_triangle``.

- Scene rays: every ray the plain wavefront hands the triangle winner on
  scenes 0, 2, 3 and 4 at 24x18, 1 spp, depth 6, and rays aimed at the
  mesh, with and without the sphere seed, in both id modes: t, id, hit
  and uv bit for bit.
- Ties (``tests/test_torch_winner_ties.py``'s meshes, BVH-ordered): the
  first copy in packed order wins, as in the chunk scan.
- Grazing rays at coplanar axis-aligned floors (flat leaf boxes;
  ``probes/walk_pad.py``'s floors and rays), at the faces of the
  teapot's leaf boxes, and the one camera ray of scene 3 at 700x700 on
  which the card's walk and chunk scan were seen to differ. The chunk scan culls with
  undilated chunk boxes and so drops some real hits on a flat floor,
  which the walk's dilated boxes keep: each ray that differs must be such
  a hit (it passes every triangle test, at a t, then a packed position,
  below the chunk scan's). The test prints how many there are.
- JAX's ``bvh_closest_triangle`` computes with vertices, the port with
  planes that differ by up to 2 ulps (ROADMAP.md Queue 3 (b2)): hit and
  id equal and t within 1e-5 relative, leaving out the near-tied rays (a
  triangle within 1e-4 of its det or t bounds, or within 1e-4 / |cos| of
  a barycentric bound, cos the incidence, as the barycentrics' rounding
  grows at grazing incidence; or two within 1e-5 relative in t); the test
  prints how many it left out.
- The twin's work counts per segment on a sample of the rays of
  ``chip_smoke.py`` phase 7 (scene 3, 700x700, depth 20), printed
  (``pytest -s``).
"""

import numpy as np
import pytest
import torch

from zraytrace_tpu.geometry.bvh import build_tri_bvh as jax_build_tri_bvh
from zraytrace_tpu.geometry.bvh import bvh_closest_triangle
from zraytrace_tpu_torch import vecmath as vm
from zraytrace_tpu_torch.geometry.bvh import build_tri_bvh
from zraytrace_tpu_torch.geometry.sphere import intersect_spheres
from zraytrace_tpu_torch.kernel_inputs import recorded_calls
from zraytrace_tpu_torch.ops import flash_intersect as fi
from zraytrace_tpu_torch.ops import mesh_bvh as mb
from zraytrace_tpu_torch.probes import walk_pad
from zraytrace_tpu_torch.render import wavefront_trace
from zraytrace_tpu_torch.scenes import build_scene

import test_torch_winner_ties as ties

torch.set_num_threads(1)

T_MIN = 1e-3
BIG = 3.4e38
SCENES = (0, 2, 3, 4)
NEAR = 1e-4  # barycentric, det and t_min guard of a near-tied ray
T_REL = 1e-5  # relative t of JAX against the port, and of a near tie


def _soup(n_tris=2000, seed=9):
    g = np.random.default_rng(seed)
    a = g.uniform(-2.0, 2.0, (n_tris, 3)).astype(np.float32)
    b = a + g.normal(scale=0.15, size=(n_tris, 3)).astype(np.float32)
    c = a + g.normal(scale=0.15, size=(n_tris, 3)).astype(np.float32)
    return tuple(torch.from_numpy(x) for x in (a, b, c))


def _mesh(name):
    if name == "soup":
        return _soup()
    s = build_scene(3, "cpu").scene
    return s.tri_a, s.tri_b, s.tri_c


def _planes(a, b, c, packed: bool):
    """BVH-ordered planes with the walk's tables: packed ids (``attrs``)
    or original ids."""
    bvh = build_tri_bvh(a, b, c)
    n = a.shape[0]
    planes = fi.pack_tri_planes(a, b, c, order=bvh.prim_order,
                                tri_mat=torch.zeros(n) if packed else None,
                                const_materials=packed)
    return mb.bvh_tables(planes, bvh), bvh


def _equal(got, want):
    return all(torch.equal(x, y) for x, y in zip(got, want))


@pytest.mark.parametrize("mesh", ["teapot", "soup"])
def test_node_arrays_match_jax(mesh):
    """The port's builder returns the JAX package's tree: every node array
    and ``prim_order`` bit for bit."""
    a, b, c = _mesh(mesh)
    want = jax_build_tri_bvh(*(x.numpy() for x in (a, b, c)))
    got = build_tri_bvh(a, b, c)
    for name in ("node_min", "node_max", "prim_start", "prim_count", "skip", "prim_order"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                      err_msg=name)
    assert got.n_nodes == want.n_nodes


def test_tables_hold_the_tree_and_the_planes():
    """Node rows: each box dilated outward, then a leaf's (start, count) or
    an internal node's (skip, 0) as int32 bits; triangle rows: the planes'
    own values in packed order."""
    a, b, c = _soup(700)
    planes, bvh = _planes(a, b, c, packed=True)
    nodes = planes.nodes
    assert nodes.shape == (bvh.n_nodes, mb.NODE_COLS)
    assert bool((nodes[:, 0:3] < bvh.node_min).all()) and bool((nodes[:, 3:6] > bvh.node_max).all())
    ints = nodes[:, 6:8].contiguous().view(torch.int32)
    leaf = bvh.prim_count > 0
    assert torch.equal(ints[:, 1], bvh.prim_count)
    assert torch.equal(ints[:, 0], torch.where(leaf, bvh.prim_start, bvh.skip))
    assert int(bvh.prim_count.max()) <= 4
    flat = planes.planes.reshape(fi.N_COMP, -1)[:, :a.shape[0]]
    assert torch.equal(planes.rows, flat[list(mb.ROW_PLANES)].t())
    mb.check_tables(planes, torch.device("cpu"))
    with pytest.raises(ValueError, match="bvh_tables"):
        mb.check_tables(planes._replace(nodes=None), torch.device("cpu"))
    with pytest.raises(ValueError, match="rows must be"):
        mb.check_tables(planes._replace(rows=planes.rows[:-1]), torch.device("cpu"))
    with pytest.raises(ValueError, match="nodes must be"):
        mb.check_tables(planes._replace(nodes=nodes[:, :6].contiguous()), torch.device("cpu"))


_SEGMENTS = {}


def _record(b, pixel_base, w, h, depth, tri_flash):
    """The rays and seeds the plain wavefront gives the flash winner
    tracing one sample of each lane's pixel: ``(o, d, t_init)``."""
    calls = {}
    with recorded_calls(calls):
        n = pixel_base.shape[0]
        wavefront_trace(b.scene, b.camera, pixel_base, 42, w, h, 1, depth, 0, n, w * h, 1,
                        tri_flash=tri_flash)
    recs = calls["flash_intersect"]
    return tuple(torch.cat([getattr(c, k) for c in recs]) for k in ("o", "d", "x"))


def scene_segments(index):
    """Scene ``index``'s BVH-ordered planes in both id modes, and rays with
    their sphere t: those of its wavefront at 24x18, 1 spp, depth 6, then
    1,024 from random points around the mesh at random points of its
    triangles: ``(packed, original, o, d, t_sphere)``."""
    if index not in _SEGMENTS:
        b = build_scene(index, "cpu")
        s = b.scene
        packed = mb.bvh_tables(*_pack(s, True))
        orig = mb.bvh_tables(*_pack(s, False))
        w, h = 24, 18
        o, d, ts = _record(b, torch.arange(w * h, dtype=torch.int32), w, h, 6, packed)
        g = np.random.default_rng(index)
        k = 1024
        tri = torch.from_numpy(g.integers(0, s.n_triangles, k))
        wts = torch.from_numpy(g.dirichlet((1.0, 1.0, 1.0), k).astype(np.float32))
        tgt = (s.tri_a[tri] * wts[:, :1] + s.tri_b[tri] * wts[:, 1:2]
               + s.tri_c[tri] * wts[:, 2:])
        size = float((packed.root[3:6] - packed.root[0:3]).norm())
        o2 = tgt + torch.from_numpy(g.normal(size=(k, 3)).astype(np.float32)) * size
        d2 = vm.normalize(tgt - o2)
        ts2, _, _ = intersect_spheres(o2, d2, s.sph_center, s.sph_radius, T_MIN, BIG)
        _SEGMENTS[index] = (packed, orig, torch.cat([o, o2]), torch.cat([d, d2]),
                            torch.cat([ts, ts2]))
    return _SEGMENTS[index]


def _pack(s, packed):
    bvh = build_tri_bvh(s.tri_a, s.tri_b, s.tri_c)
    return fi.pack_tri_planes(s.tri_a, s.tri_b, s.tri_c, order=bvh.prim_order, tri_mat=s.tri_mat,
                              const_materials=packed), bvh


@pytest.mark.parametrize("ids", ["packed", "original"])
@pytest.mark.parametrize("seeded", [True, False], ids=["seeded", "unseeded"])
@pytest.mark.parametrize("index", SCENES)
def test_twin_equals_chunk_scan_on_scene_rays(index, seeded, ids):
    packed, orig, o, d, ts = scene_segments(index)
    planes = packed if ids == "packed" else orig
    t_init = ts if seeded else None
    want = fi.flash_intersect_plain(planes, o, d, T_MIN, t_init)
    got, work = mb.bvh_winner_plain(planes, o, d, T_MIN, t_init)
    assert int(want[2].sum()) > 0
    for name, x, y in zip(("t", "id", "hit", "uv"), got, want):
        assert torch.equal(x, y), (name, int((x != y).reshape(len(o), -1).any(1).sum()))
    assert work["u"] <= work["t"] <= work["det"] <= work["tris"] <= 4 * work["leaves"]
    assert work["leaves"] < work["nodes"]


@pytest.mark.parametrize("packed", [False, True], ids=["orig-ids", "packed-ids"])
@pytest.mark.parametrize("case", list(ties.CASES))
def test_twin_ties(case, packed):
    """Exact copies of one triangle and a hit tied with the seed, on the
    tie meshes packed in BVH order: the first copy in packed order wins,
    and the seed keeps its tie, as in the chunk scan."""
    first, second = ties.CASES[case]
    planes, bvh = _planes(*ties.tie_mesh(first, second), packed=packed)
    _, o, d, t_init, _ = ties.flash_case(case, packed)
    want = fi.flash_intersect_plain(planes, o, d, T_MIN, t_init)
    got, _ = mb.bvh_winner_plain(planes, o, d, T_MIN, t_init)
    assert _equal(got, want)
    pos = torch.argsort(bvh.prim_order)  # packed position of each triangle
    win = min(int(pos[first]), int(pos[second]))
    win_id = win if packed else int(bvh.prim_order[win])
    assert got[2].tolist() == [True, False, True, False]
    assert torch.equal(got[0], torch.tensor([1.0, 1.0, 1.0, BIG]))
    assert got[1].tolist() == [win_id, 0, win_id, 0]


def _box_faces(bvh, n, g):
    """Rays from random directions at random points on the faces of random
    leaf boxes (the tight ones), from 2 to 12 units away."""
    leaves = torch.nonzero(bvh.prim_count > 0)[:, 0].numpy()
    pick = g.choice(leaves, n)
    lo, hi = bvh.node_min.numpy()[pick], bvh.node_max.numpy()[pick]
    p = lo + g.uniform(0.0, 1.0, (n, 3)) * (hi - lo)
    axis = g.integers(0, 3, n)
    side = g.integers(0, 2, n).astype(bool)
    p[np.arange(n), axis] = np.where(side[:, None], hi, lo)[np.arange(n), axis]
    d = g.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = p - d * g.uniform(2.0, 12.0, (n, 1))
    return (torch.tensor(o, dtype=torch.float32),
            vm.normalize(torch.tensor(d, dtype=torch.float32)))


GRAZING = {**walk_pad.FLOORS, "teapot_leaf_faces": None, "teapot_seam": "seam"}
# A camera ray of scene 3 at 700x700 (pixel 387,871) that crosses two
# adjacent triangles 1e-6 apart in t, the nearer one a rounding outside
# its chunk's box: the chunk scan culls that chunk and takes the farther
# triangle, the walk's dilated leaf box keeps the nearer.
SEAM_RAY = ((0.0, 0.0, -10.0), (0.3056597411632538, 0.22374065220355988, 0.9254794716835022))


def _real_hit(planes, o, d, pos, t):
    """Does the triangle at packed position ``pos`` pass every test of the
    flash winner for these rays, at ``t``?"""
    q = planes.planes.reshape(fi.N_COMP, -1)[:, pos]
    (e1x, e1y, e1z, e2x, e2y, e2z, fnx, fny, fnz, qax, qay, qaz, rax, ray_, raz, adf) = q[:16]
    dx, dy, dz = d.unbind(1)
    ox, oy, oz = o.unbind(1)
    px, py, pz = oy * dz - oz * dy, oz * dx - ox * dz, ox * dy - oy * dx
    det = -(dx * fnx + dy * fny + dz * fnz)
    inv_det = 1.0 / torch.where(det.abs() > 1e-12, det, 1.0)
    u = (px * e2x + py * e2y + pz * e2z - (dx * qax + dy * qay + dz * qaz)) * inv_det
    v = -(px * e1x + py * e1y + pz * e1z - (dx * rax + dy * ray_ + dz * raz)) * inv_det
    tt = (ox * fnx + oy * fny + oz * fnz - adf) * inv_det
    return ((det >= 1e-6) & (tt > T_MIN) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
            & (tt == t))


@pytest.mark.parametrize("case", list(GRAZING))
def test_twin_on_grazing_rays_differs_only_by_real_hits(case):
    g = np.random.default_rng(list(GRAZING).index(case) + 1)
    if GRAZING[case] is None or GRAZING[case] == "seam":
        a, b, c = _mesh("teapot")
        planes, bvh = _planes(a, b, c, packed=True)
        if GRAZING[case] is None:
            o, d = _box_faces(bvh, 8000, g)
        else:
            o, d = (torch.tensor([x], dtype=torch.float32) for x in SEAM_RAY)
    else:
        y0, x0, cell = GRAZING[case]
        (a, b, c), xs = walk_pad.floor(y0, x0, cell)
        planes, _ = _planes(a, b, c, packed=True)
        o, d = walk_pad.grazing_rays(xs, np.float32(y0), 12000, g)
    want = fi.flash_intersect_plain(planes, o, d, T_MIN)
    got, _ = mb.bvh_winner_plain(planes, o, d, T_MIN)
    assert int(want[2].sum()) > len(o) // 10
    (gt, gi, gh, _), (wt, wi, wh, _) = got, want
    differ = torch.nonzero((gt != wt) | (gi != wi) | (gh != wh))[:, 0]
    print(f"{case}: {len(o)} rays, {int(wh.sum())} chunk-scan hits; the walk differs on "
          f"{len(differ)}, each a real hit the chunk scan's box cull dropped")
    r = differ
    assert bool(gh[r].all()), "the walk missed a hit of the chunk scan"
    earlier = ~wh[r] | (gt[r] < wt[r]) | ((gt[r] == wt[r]) & (gi[r] < wi[r]))
    assert bool(earlier.all()), "the walk's winner is not before the chunk scan's"
    assert bool(_real_hit(planes, o[r], d[r], gi[r].long(), gt[r]).all())
    if GRAZING[case] is not None:  # the floors' flat chunk boxes, and the seam, drop hits
        assert len(differ) > 0


def _near_tied(planes, o, d, t_init):
    """Rays whose winner could turn on the last ulps: some triangle within
    ``NEAR`` of its det or t_min bound, within ``NEAR / |cos|`` of a
    barycentric bound or within ``T_REL`` of the seed, or two triangles
    within ``T_REL`` relative in t; from every triangle's plane arithmetic
    (the brute force)."""
    q = planes.planes.reshape(fi.N_COMP, -1)[:, :planes.n_tris]
    fn, e1, e2, qa, ra, adf = q[6:9], q[0:3], q[3:6], q[9:12], q[12:15], q[15]
    out = []
    for s in range(0, len(o), 512):  # a tolerance test: products as matmuls
        oo, dd, ti = o[s:s + 512], d[s:s + 512], t_init[s:s + 512, None]
        pxd = torch.linalg.cross(oo, dd, dim=1)
        det = -(dd @ fn)
        inv = 1.0 / torch.where(det.abs() > 1e-12, det, 1.0)
        u = (pxd @ e2 - dd @ qa) * inv
        v = -(pxd @ e1 - dd @ ra) * inv
        t = (oo @ fn - adf) * inv
        m = torch.minimum(torch.minimum(u, v), 1.0 - u - v)
        # the barycentrics' rounding grows as 1 / |cos| of the incidence
        tol = NEAR / (det.abs() / fn.norm(dim=0)).clamp(min=NEAR)
        loose = ((det >= 1e-6 * (1 - NEAR)) & (t > T_MIN * (1 - NEAR))
                 & (t < ti * (1 + T_REL)) & (m >= -tol))
        strict = ((det >= 1e-6 * (1 + NEAR)) & (t > T_MIN * (1 + NEAR))
                  & (t < ti * (1 - T_REL)) & (m >= tol))
        tl = torch.where(loose, t, float("inf")).amin(1)
        ts = torch.where(strict, t, float("inf")).amin(1)
        close = (loose & (t <= tl[:, None] * (1 + T_REL))).sum(1)
        out.append((ts != tl) | (close > 1))
    return torch.cat(out)


@pytest.mark.parametrize("index", SCENES)
def test_twin_matches_jax_traversal(index):
    """JAX's ``bvh_closest_triangle`` on the same rays and seeds: hit and
    original id equal and t within 1e-5 relative, on every ray that is not
    near-tied."""
    _, planes, o, d, ts = scene_segments(index)
    s = build_scene(index, "cpu").scene
    (t, idx, hit, _), _ = mb.bvh_winner_plain(planes, o, d, T_MIN, ts)
    a, b, c = (x.numpy() for x in (s.tri_a, s.tri_b, s.tri_c))
    jt, jidx, jhit, _ = bvh_closest_triangle(jax_build_tri_bvh(a, b, c), a, b, c, o.numpy(),
                                             d.numpy(), T_MIN, ts.numpy())
    jt, jidx, jhit = (torch.from_numpy(np.array(x)) for x in (jt, jidx, jhit))
    tied = _near_tied(planes, o, d, ts)
    keep = ~tied
    print(f"scene {index}: {len(o)} rays, {int(hit.sum())} hits; {int(tied.sum())} near-tied "
          f"rays left out")
    assert int(tied.sum()) < len(o) // 20
    assert torch.equal(hit[keep], jhit[keep])
    both = keep & hit
    assert int(both.sum()) > 0
    assert torch.equal(idx[both], jidx[both].to(torch.int32))
    rel = ((t[both] - jt[both]).abs() / jt[both].abs()).max()
    assert float(rel) <= T_REL, float(rel)


def test_twin_work_on_phase7_segments():
    """A sample of the segments of ``chip_smoke.py`` phase 7 (scene 3,
    700x700 lanes, depth 20; 300 pixels, one sample each): the twin equals
    the chunk scan, and its work per segment that reaches the mesh's root
    box is printed against the chunk scan's 128 tests per chunk visit."""
    b = build_scene(3, "cpu")
    s = b.scene
    packed = mb.bvh_tables(*_pack(s, True))
    pix = np.sort(np.random.default_rng(7).choice(700 * 700, 300, replace=False))
    o, d, ts = _record(b, torch.from_numpy(pix.astype(np.int32)), 700, 700, 20, packed)
    near, far = fi._slab(packed.root[0:3], packed.root[3:6], o, fi._inv_dir(d))
    root = (near <= far) & (far > T_MIN) & (near <= ts)
    o, d, ts = o[root], d[root], ts[root]
    want = fi.flash_intersect_plain(packed, o, d, T_MIN, ts)
    got, work = mb.bvh_winner_plain(packed, o, d, T_MIN, ts)
    assert _equal(got, want)
    n = len(o)
    reach = fi.ray_chunk_reach(packed.bounds, o, d, ts, T_MIN).sum(1).double().mean()
    per = {k: round(v / n, 3) for k, v in work.items()}
    print(f"phase 7 sample: {n} segments reach the root box; per segment {per} "
          f"({per['nodes']} node slab tests, {per['leaves']} leaves, {per['tris']} triangle "
          f"tests); at the seed the chunk scan's cull reaches {float(reach):.3f} of "
          f"{packed.n_chunks} chunk boxes, at most {128 * float(reach):.1f} triangle tests")
    assert n > 100
    assert per["tris"] < 16 and per["nodes"] < 80
