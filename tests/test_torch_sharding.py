"""The port's distributed paths (``zraytrace_tpu_torch/parallel/``,
``inverse.make_sharded_train_step``, ``dryrun.py``) on gloo ranks of the
CPU, against the port's single-process ``render()`` and ``make_loss_fn``
and against the JAX package's ``render_sharded``, ``make_sharded_intersector``
and ``jax.grad`` of ``make_loss_fn`` on tests/conftest.py's 8 virtual CPU
devices.

The ranks are fresh processes (``multihost.run_ranks``: spawn, a
rendezvous file, every rank joined with a timeout); one start of four
ranks runs every case, and they import the port and numpy only. JAX is
imported inside the tests. The three-balls scene at a cut size is also
held to the benchmark's plain reference (``benchmark/reference/``), with
``render_sharded``'s spans and counters.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from zraytrace_tpu_torch import RenderParams
from zraytrace_tpu_torch.convert import camera_from_numpy, scene_from_numpy

torch.set_num_threads(1)

MESHES = [(4, 1), (2, 2), (1, 4), (1, 1)]
W = H = 8
SPP, DEPTH = 4, 4
# tests/test_sharding.py's training-step setting (its mesh is 4x2 over 8
# devices; here 2x2 and 1x4 over 4 ranks: 1x4 sums three earlier sample
# ranks in the no-grad pass)
STEP_MESHES, STEP_SPP, STEP_DEPTH = [(2, 2), (1, 4)], 4, 3
TRI_MESHES = [(4, 1), (2, 2)]
# the three-balls scene (scenes.build_scene(1)) at a cut size of its
# benchmark configuration, on the meshes of four ranks
BALLS = dict(width=12, height=10, spp=2, depth=5, seed=3_456_789_012)
BALLS_MESHES = [(4, 1), (2, 2)]
MESH_CHILDREN = {"mesh.prepare", "mesh.trace", "mesh.allreduce", "mesh.fetch", "mesh.divide"}
# the JAX gradient bar (tests/test_torch_diff.py, tests/test_diff_mesh.py)
GRAD_ATOL, GRAD_RTOL = 5e-4, 2e-3


def _cross(fields, cam):
    return scene_from_numpy(fields, "cpu"), camera_from_numpy(*cam, device="cpu")


def _counters(st):
    return [st.rays, st.reflections, st.background_hits, st.recursion_depth_hits, st.samples]


def _record_counters():
    """The counters of this rank's last ``mesh.render`` record."""
    from zraytrace_tpu_torch import profiling

    return dict(profiling.records("mesh.render")[-1].counters)


def _cases_rank(rank, world, fields, cam, tris):
    """Every case on one rank: ``render_sharded`` at 8x8 on each mesh of
    MESHES with ``world`` ranks; with 4 ranks also on 4x1 at 9x7 (which
    does not divide), the sharded intersector on TRI_MESHES and one
    training step on each of STEP_MESHES. Returns what each produced on
    this rank."""
    from zraytrace_tpu_torch.inverse import make_sharded_train_step, split_scene
    from zraytrace_tpu_torch.parallel.mesh import make_mesh, render_sharded
    from zraytrace_tpu_torch.parallel.primshard import make_sharded_intersector

    scene, camera = _cross(fields, cam)
    out = {}
    for shape in MESHES:
        if shape[0] * shape[1] != world:
            continue
        mesh = make_mesh(*shape, device="cpu")
        img, st = render_sharded(scene, camera, RenderParams(
            width=W, height=H, samples_per_pixel=SPP, max_depth=DEPTH), mesh)
        out[("render", shape)] = (img.numpy(), _counters(st), st.wavefront_iterations,
                                  _record_counters())
    if world != 4:
        return out
    out["env"] = (os.environ["LOCAL_RANK"], os.environ["LOCAL_WORLD_SIZE"])
    out.update(_three_balls_rank())
    mesh = make_mesh(4, 1, device="cpu")
    img, st = render_sharded(scene, camera, RenderParams(
        width=9, height=7, samples_per_pixel=SPP, max_depth=DEPTH), mesh)
    out[("render", "9x7")] = (img.numpy(), _counters(st), st.wavefront_iterations,
                              _record_counters())

    a, b, c, o, d = (torch.from_numpy(x) for x in tris)
    for shape in TRI_MESHES:
        fn = make_sharded_intersector(make_mesh(*shape, device="cpu"), a.shape[0])
        out[("tri", shape)] = tuple(x.numpy() for x in fn(a, b, c, o, d))

    for shape in STEP_MESHES:
        params, static = split_scene(scene)
        params = {f: v.clone().requires_grad_(True) for f, v in params.items()}
        step_fn, _ = make_sharded_train_step(make_mesh(*shape, device="cpu"), params, static,
                                             camera, W, H, STEP_SPP, STEP_DEPTH, seed=42)
        loss = step_fn(torch.zeros((W * H, 3)))
        out[("step", shape)] = (
            float(loss), {f: np.zeros(p.shape, np.float32) if p.grad is None
                          else p.grad.numpy() for f, p in params.items()},
            {f: p.detach().numpy() for f, p in params.items()})
    return out


def _three_balls_rank():
    """``render_sharded`` of the three-balls scene at ``BALLS`` on each of
    ``BALLS_MESHES``: the image, the counters, and the call's
    ``mesh.render`` record (its span names and counters), and the
    iterations."""
    from zraytrace_tpu_torch import profiling
    from zraytrace_tpu_torch.parallel.mesh import make_mesh, render_sharded
    from zraytrace_tpu_torch.scenes import build_scene

    built = build_scene(1, device="cpu")
    out = {}
    for shape in BALLS_MESHES:
        img, st = render_sharded(built.scene, built.camera, _balls_params(),
                                 make_mesh(*shape, device="cpu"))
        rec = profiling.records("mesh.render")[-1]
        out[("balls", shape)] = (img.numpy(), _counters(st),
                                 {name for name, _ in rec.spans}, dict(rec.counters),
                                 st.wavefront_iterations)
    return out


def _balls_params():
    return RenderParams(width=BALLS["width"], height=BALLS["height"],
                        samples_per_pixel=BALLS["spp"], max_depth=BALLS["depth"],
                        seed=BALLS["seed"])


def _blocks(spp, n_data):
    """The sample blocks of a rank, as the lane map cuts them: ``min(n_data,
    spp)`` blocks of ``ceil(spp / that)``, the last holding the rest."""
    q = -(-spp // min(n_data, spp))
    return [(off, min(q, spp - off)) for off in range(0, spp, q)]


def _triangles(seed=3, n_tris=13, n_rays=64):
    """Triangles in front of the rays, two duplicated for exact ties, and
    rays from the origin toward them."""
    r = np.random.default_rng(seed)
    a = r.uniform(-1, 1, (n_tris, 3)).astype(np.float32) + np.float32([0, 0, 3])
    b = a + r.uniform(-0.8, 0.8, (n_tris, 3)).astype(np.float32)
    c = a + r.uniform(-0.8, 0.8, (n_tris, 3)).astype(np.float32)
    for x in (a, b, c):
        x[7], x[11] = x[2], x[5]  # ties across shards: the lower id wins
    o = np.zeros((n_rays, 3), np.float32)
    d = r.normal(size=(n_rays, 3)).astype(np.float32) * np.float32([0.3, 0.3, 0.0])
    d[:, 2] = 1.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return a, b, c, o, d


@pytest.fixture(scope="module")
def mini():
    from test_render import _mini_scene

    jscene, jcam = _mini_scene()
    fields = {k: np.asarray(v) for k, v in jscene._asdict().items()}
    return (jscene, jcam), fields, list(map(np.asarray, jcam))


@pytest.fixture(scope="module")
def ranks(mini):
    """Every case, once, on 4 gloo ranks."""
    from zraytrace_tpu_torch.parallel.multihost import run_ranks

    _, fields, cam = mini
    return run_ranks(_cases_rank, 4, fields, cam, _triangles(), timeout=150)


def _jax_mesh(shape):
    import jax

    from zraytrace_tpu.parallel.mesh import make_mesh

    return make_mesh(n_data=shape[0], n_sample=shape[1],
                     devices=jax.devices()[:shape[0] * shape[1]])


def _case(ranks, fields, cam, case):
    """A render case's mesh shape, image size and every rank's
    ``(image, counters, iterations, record counters)``."""
    shape = (4, 1) if case == "9x7" else case
    w, h = (9, 7) if case == "9x7" else (W, H)
    if shape[0] * shape[1] == 4:
        return shape, (w, h), [r[("render", case)] for r in ranks]
    # the one-rank mesh, in a group of its own
    from zraytrace_tpu_torch.parallel.multihost import run_ranks

    return shape, (w, h), [r[("render", shape)] for r in run_ranks(
        _cases_rank, 1, fields, cam, _triangles(), timeout=120)]


@pytest.mark.parametrize("case", [*MESHES, "9x7"], ids=str)
def test_render_sharded(ranks, mini, case):
    """Against the sample blocks' contract (``reference_sums``: the
    in-order block sums of ``render.trace_lanes`` over each rank's sample
    ranges, bit for bit where at most two sample shards meet; iterations
    the longest block lane's), the port's ``render()`` on the CPU (counters
    exact, the image within 1e-5: the block sums add in another order than
    one running sum; bit for bit on one rank) and JAX's ``render_sharded``
    on a mesh of the same shape (counters exact, the image within 1e-5).
    Every rank returns the same image."""
    from zraytrace_tpu.config import RenderParams as JaxParams
    from zraytrace_tpu.parallel.mesh import render_sharded as jax_render_sharded
    from sharded_reference import reference_sums
    from zraytrace_tpu_torch.render import render

    (jscene, jcam), fields, cam = mini
    shape, (w, h), got = _case(ranks, fields, cam, case)
    img, counters, iters, _ = got[0]
    for other in got[1:]:
        np.testing.assert_array_equal(other[0], img)
        assert other[1:3] == (counters, iters)

    scene, camera = _cross(fields, cam)
    params = RenderParams(width=w, height=h, samples_per_pixel=SPP, max_depth=DEPTH)
    want_img, want = render(scene, camera, params, device="cpu")
    assert counters == _counters(want)
    np.testing.assert_allclose(img, want_img.numpy(), atol=1e-5, rtol=0)
    sums, ref_counters = reference_sums(scene, camera, params, *shape)
    assert ref_counters == [*counters, iters]
    if shape[1] <= 2:
        np.testing.assert_array_equal(img, (sums / SPP).reshape(h, w, 3).numpy())
    if shape == (1, 1):
        np.testing.assert_array_equal(img, want_img.numpy())
        assert iters == want.wavefront_iterations

    jimg, jst = jax_render_sharded(jscene, jcam, JaxParams(
        width=w, height=h, samples_per_pixel=SPP, max_depth=DEPTH), _jax_mesh(shape))
    assert counters == _counters(jst)
    np.testing.assert_allclose(img, np.asarray(jimg), atol=1e-5, rtol=0)


@pytest.mark.parametrize("shape", BALLS_MESHES, ids=str)
def test_render_sharded_three_balls_against_the_reference(ranks, shape):
    """The three-balls scene (textured spheres, metal, glass) at a cut size
    against the benchmark's plain reference over every pixel: counters
    exact; the image equal bit for bit to the reference's paths summed as
    the lane map sums them (each rank's sample blocks in sample order from
    zero, the blocks added in block order, then the two sample shards:
    ``render()`` on the CPU equals the reference path for path), and
    within 1e-5 of the reference's one running sum over the samples
    (float32 rounding of values below 2)."""
    from benchmark.reference import render as ref_render
    from benchmark.reference import scene as ref_scene

    repo = __import__("pathlib").Path(__file__).resolve().parents[1]
    cfg = json.loads((repo / "benchmark" / "configs" / "threeBalls.json").read_text())
    desc = cfg["scenes"][cfg["render"]["scene"]]
    img, counters = ranks[0][("balls", shape)][:2]
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[("balls", shape)][0], img)
        assert r[("balls", shape)][1] == counters
    w, h, spp = BALLS["width"], BALLS["height"], BALLS["spp"]
    scene = ref_scene.build(desc, repo, "cpu")
    vals, counts = ref_render.render_pixels(scene, BALLS["seed"], torch.arange(w * h), w, h,
                                            spp, BALLS["depth"])
    assert counters == [counts[k] for k in ("rays", "reflections", "background_hits",
                                            "recursion_depth_hits", "samples")]
    np.testing.assert_allclose(img, vals.reshape(h, w, 3).numpy(), atol=1e-5, rtol=0)

    rad, _ = ref_render.trace_paths(scene, None, BALLS["seed"],
                                    torch.arange(w * h).repeat_interleave(spp),
                                    torch.arange(spp).repeat(w * h), w, h, BALLS["depth"],
                                    torch.float32)
    rad = rad.reshape(w * h, spp, 3)
    n_data, n_sample = shape
    local = spp // n_sample
    total = None
    for s in range(n_sample):
        shard = None
        for off, count in _blocks(local, n_data):
            acc = torch.zeros((w * h, 3))
            for k in range(s * local + off, s * local + off + count):
                acc = acc + rad[:, k]
            shard = acc if shard is None else shard + acc
        total = shard if total is None else total + shard
    want = total / torch.full((), float(spp))
    np.testing.assert_array_equal(img, want.reshape(h, w, 3).numpy())


@pytest.mark.parametrize("shape", BALLS_MESHES, ids=str)
def test_render_sharded_spans_and_counters(ranks, shape):
    """Each rank's ``mesh.render`` record holds its five child spans; three
    all-reduces a call, of the slot-sum buffer (every rank's lanes: its
    warps of 32, padded to one count) and the counters' bytes; the ranks'
    own rays sum to the image's."""
    n_data = shape[0]
    per = -(-(-(-BALLS["width"] * BALLS["height"] // 32)) // n_data) * 32
    buffer_bytes = per * n_data * 3 * 4 + 6 * 8  # f32 sums, five events and the iterations
    own = 0
    for r in ranks:
        _, counters, names, counts, _ = r[("balls", shape)]
        assert MESH_CHILDREN <= names
        assert counts["collective.all_reduce"] == 3
        assert counts["collective.bytes"] == buffer_bytes
        own += counts["mesh.rank_rays"]
    assert own == ranks[0][("balls", shape)][1][0]


LANE_MAP_CASES = [(4, 1), (2, 2), "9x7", "balls (4, 1)", "balls (2, 2)"]


@pytest.mark.parametrize("case", LANE_MAP_CASES, ids=str)
def test_sharded_lane_map(ranks, mini, case):
    """Where each rank's work goes: ``rank_lanes`` gives every lane of
    ``render()`` to exactly one rank, in whole warps of 32 consecutive
    lanes, the ranks' real lanes differing by at most one warp; each
    rank's ``mesh.lanes`` is its pixel lanes times its sample blocks
    (``render()``'s lane count, plus under a warp of padding a rank, where
    the blocks are as many as the ranks); the ranks' ``mesh.rank_rays``
    sum to the image's rays; the iterations are the longest block lane's
    (``reference_sums``)."""
    from sharded_reference import reference_sums
    from zraytrace_tpu_torch.parallel.mesh import rank_lanes
    from zraytrace_tpu_torch.scenes import build_scene

    _, fields, cam = mini
    if isinstance(case, str) and case.startswith("balls"):
        shape = BALLS_MESHES[0] if "(4, 1)" in case else BALLS_MESHES[1]
        w, h, spp = BALLS["width"], BALLS["height"], BALLS["spp"]
        params = _balls_params()
        got = [(r[("balls", shape)][0], r[("balls", shape)][1], r[("balls", shape)][4],
                r[("balls", shape)][3]) for r in ranks]
        built = build_scene(1, device="cpu")
        scene, camera = built.scene, built.camera
    else:
        shape, (w, h), got = _case(ranks, fields, cam, case)
        spp = SPP
        params = RenderParams(width=w, height=h, samples_per_pixel=SPP, max_depth=DEPTH)
        scene, camera = _cross(fields, cam)
    n_data, n_sample = shape
    n = w * h
    lanes = [rank_lanes(n, n_data, d, n, "cpu") for d in range(n_data)]
    per = lanes[0].shape[0]
    assert all(x.shape == (per,) and per % 32 == 0 for x in lanes)
    real = torch.cat(lanes)
    real = real[real < n]
    assert torch.equal(real.sort().values, torch.arange(n, dtype=torch.int32))
    assert all(bool(((x == n) | (x < n)).all()) for x in lanes)
    for x in lanes:  # whole warps of render(): 32 consecutive lanes from a multiple of 32
        warps = x.reshape(-1, 32)
        live = warps[:, 0] < n
        assert bool((warps[live, 0] % 32 == 0).all())
        first = warps[live, :1]
        assert bool(((warps[live] == first + torch.arange(32)) | (warps[live] == n)).all())
    sizes = [int((x < n).sum()) for x in lanes]
    assert max(sizes) - min(sizes) <= 32

    blocks = len(_blocks(spp // n_sample, n_data))
    assert [c["mesh.lanes"] for *_, c in got] == [blocks * per] * len(got)
    if blocks == n_data:
        assert n <= blocks * per < n + 32 * n_data
    assert sum(c["mesh.rank_rays"] for *_, c in got) == got[0][1][0]
    _, ref_counters = reference_sums(scene, camera, params, *shape)
    assert ref_counters == [*got[0][1], got[0][2]]


@pytest.mark.parametrize("spp,blocks,want", [
    (4, 4, [(0, 1), (1, 1), (2, 1), (3, 1)]),
    (1000, 4, [(0, 250), (250, 250), (500, 250), (750, 250)]),
    (7, 4, [(0, 2), (2, 2), (4, 2), (6, 1)]),
    (5, 4, [(0, 2), (2, 2), (4, 1)]),  # ceil(5 / 4) = 2: three blocks, none empty
    (2, 4, [(0, 1), (1, 1)]),
    (9, 1, [(0, 9)]),
])
def test_sample_blocks(spp, blocks, want):
    from zraytrace_tpu_torch.render import sample_blocks

    assert sample_blocks(spp, blocks) == want == _blocks(spp, blocks)


@pytest.mark.parametrize("n_lanes,n_data", [(1_000_000, 4), (63, 4), (120, 2), (33, 1)])
def test_rank_lanes_deal_warps(n_lanes, n_data):
    """The lane map at the benchmark's size (1,000,000 lanes over 4 ranks:
    7,813 warps on ranks 0 and 1, 7,812 and a padding warp on ranks 2 and
    3) and at ragged ones: a partition of the lanes into whole warps, dealt
    round-robin."""
    from zraytrace_tpu_torch.parallel.mesh import rank_lanes

    lanes = [rank_lanes(n_lanes, n_data, d, n_lanes, "cpu") for d in range(n_data)]
    chunks = -(-n_lanes // 32)
    for d, x in enumerate(lanes):
        assert x.shape == (-(-chunks // n_data) * 32,)
        want = (torch.arange(x.shape[0] // 32) * n_data + d)[:, None] * 32 + torch.arange(32)
        want = want.reshape(-1).to(torch.int32)
        assert torch.equal(x, torch.where(want < n_lanes, want, n_lanes))
    real = torch.cat(lanes)
    assert torch.equal(real[real < n_lanes].sort().values,
                       torch.arange(n_lanes, dtype=torch.int32))


def test_run_ranks_sets_the_local_rank(ranks):
    """As ``torchrun`` does on one host."""
    assert [r["env"] for r in ranks] == [(str(i), "4") for i in range(4)]


@pytest.mark.parametrize("device,rank,want", [
    ("cuda", 0, "cuda:0"), ("cuda", 3, "cuda:3"), ("cuda:0", 2, "cuda:0"), ("cpu", 1, "cpu"),
    (None, 1, None)])
def test_rank_device(device, rank, want):
    """One card a rank where the device names the card without an index;
    an indexed card or the CPU is every rank's."""
    from zraytrace_tpu_torch.parallel.multihost import rank_device

    got = rank_device(rank, device)
    assert (None if got is None else str(got)) == want


def test_run_ranks_refuses_more_ranks_than_cards(monkeypatch):
    from zraytrace_tpu_torch.parallel import multihost

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(RuntimeError, match="need cuda:0 to cuda:3; this host has 2"):
        multihost.run_ranks(print, 4, device="cuda")


@pytest.mark.parametrize("shape", TRI_MESHES, ids=str)
def test_sharded_intersector(ranks, shape):
    """Against the port's ``intersect_triangles`` over all triangles: t,
    id, hit and uv equal bit for bit (the duplicated triangles keep the
    lower id). Against JAX's sharded intersector on the same triangles and
    rays: id and hit equal, uv within 1e-6 and t within 1e-6 relative:
    XLA's CPU backend contracts the products into fused multiply-adds,
    the port rounds each (tests/test_torch_flash.py), which moves t by an
    ulp or two."""
    import jax.numpy as jnp

    from zraytrace_tpu.parallel.primshard import make_sharded_intersector as jax_intersector
    from zraytrace_tpu_torch.geometry.sphere import BIG
    from zraytrace_tpu_torch.geometry.triangle import intersect_triangles

    tris = _triangles()
    got = ranks[0][("tri", shape)]
    for r in ranks[1:]:
        for x, y in zip(r[("tri", shape)], got):
            np.testing.assert_array_equal(x, y)
    t, idx, hit, uv = got
    assert hit.any() and not hit.all()
    assert not np.isin(idx[hit], [7, 11]).any()
    a, b, c, o, d = map(torch.from_numpy, tris)
    want = intersect_triangles(o, d, a, b, c, 1e-3, BIG)
    for name, x, y in zip(("t", "idx", "hit"), got, want):
        np.testing.assert_array_equal(x, y.numpy(), err_msg=name)
    np.testing.assert_array_equal(uv[hit], want[3].numpy()[hit])
    jt, jidx, jhit, juv = jax_intersector(_jax_mesh(shape), tris[0].shape[0])(
        *map(jnp.asarray, tris))
    np.testing.assert_array_equal(idx, np.asarray(jidx))
    np.testing.assert_array_equal(hit, np.asarray(jhit))
    np.testing.assert_allclose(t, np.asarray(jt), rtol=1e-6, atol=0)
    np.testing.assert_allclose(uv, np.asarray(juv), atol=1e-6, rtol=0)


@pytest.fixture(scope="module")
def step_reference(mini):
    """The training step's loss and gradients in one process: JAX's
    ``make_loss_fn`` under ``jax.value_and_grad``, and the port's
    ``make_loss_fn``, its loss and each field's gradient."""
    import jax
    import jax.numpy as jnp

    from zraytrace_tpu.inverse import make_loss_fn as jax_make_loss_fn
    from zraytrace_tpu.inverse import split_scene as jax_split
    from zraytrace_tpu_torch.inverse import make_loss_fn, split_scene

    (jscene, jcam), fields, cam = mini
    jparams, jstatic = jax_split(jscene)
    jloss, jgrads = jax.value_and_grad(jax_make_loss_fn(
        jstatic, jcam, jnp.zeros((H, W, 3)), W, H, STEP_SPP, STEP_DEPTH, seed=42))(jparams)
    scene, camera = _cross(fields, cam)
    params, static = split_scene(scene)
    params = {f: v.clone().requires_grad_(True) for f, v in params.items()}
    single = make_loss_fn(static, camera, torch.zeros((H, W, 3)), W, H, STEP_SPP, STEP_DEPTH,
                          seed=42)(params)
    single.backward()
    return ((float(jloss), {f: np.asarray(g) for f, g in jgrads.items()}),
            (float(single.detach()), {f: None if p.grad is None else p.grad.numpy()
                                      for f, p in params.items()}))


@pytest.mark.parametrize("shape", STEP_MESHES, ids=str)
def test_sharded_train_step(ranks, mini, step_reference, shape):
    """tests/test_sharding.py's setting: the loss within 1e-5 of JAX's
    ``make_loss_fn``, each field's all-reduced gradient within the JAX
    gradient bar of ``jax.grad`` (the glass ball's ``mat_ior`` through
    the REINFORCE baseline, which a no-grad pass carries across the
    sample ranks), and of the port's single-process ``make_loss_fn``
    within a thousandth of its largest entry; after the step every rank
    holds the same finite parameters, and they moved."""
    _, fields, _ = mini
    (jloss, jgrads), (sloss, sgrads) = step_reference
    loss, grads, new = ranks[0][("step", shape)]
    for r in ranks[1:]:
        assert r[("step", shape)][0] == loss
        for f in new:
            np.testing.assert_array_equal(r[("step", shape)][2][f], new[f], err_msg=f)
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    np.testing.assert_allclose(loss, sloss, rtol=1e-5)
    moved = False
    for f, g in grads.items():
        gj = jgrads[f]
        gs = np.zeros_like(g) if sgrads[f] is None else sgrads[f]
        if g.size:
            np.testing.assert_allclose(g, gj, atol=GRAD_ATOL * np.abs(gj).max(), rtol=GRAD_RTOL,
                                       err_msg=f)
            np.testing.assert_allclose(g, gs, atol=1e-3 * np.abs(gs).max(), rtol=0, err_msg=f)
        assert np.isfinite(new[f]).all(), f
        moved |= not np.array_equal(new[f], fields[f])
    assert np.abs(grads["mat_ior"]).max() > 0
    assert moved


def test_dryrun_multichip():
    from zraytrace_tpu_torch.dryrun import dryrun_multichip

    outs = dryrun_multichip(2, "cpu")
    assert [o["mesh"] for o in outs] == [(1, 2), (1, 2)]
    assert outs[0]["loss"] == outs[1]["loss"] and np.isfinite(outs[0]["loss"])
    assert outs[0]["rays"] > 0


_INIT_CODE = """
import datetime, sys, tempfile, os
import torch.distributed as dist
from zraytrace_tpu_torch.parallel import multihost
for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_WORLD_SIZE"):
    os.environ.pop(k, None)
multihost.initialize()
assert not dist.is_initialized() and multihost.is_coordinator()
assert multihost.global_device_count() == 1 and multihost.local_device_count() == 1
with tempfile.TemporaryDirectory() as tmp:
    try:
        multihost.initialize(backend="gloo", init_method=f"file://{tmp}/r", world_size=2, rank=0,
                             timeout=datetime.timedelta(seconds=2))
    except Exception as e:
        print("raised", type(e).__name__)
        sys.exit(0)
print("did not raise")
sys.exit(1)
"""


def test_multihost_initialize():
    """Without kwargs and without a rendezvous in the environment the
    process runs standalone; explicit kwargs that cannot meet (a second
    rank that never comes) raise."""
    r = subprocess.run([sys.executable, "-c", _INIT_CODE], capture_output=True, text=True,
                       timeout=60, cwd=str(__import__("pathlib").Path(__file__).parents[1]))
    assert r.returncode == 0, r.stdout + r.stderr
    assert "raised" in r.stdout


def test_entry_points_need_a_card_by_default():
    """The mesh and the dry run run on the card unless asked for the CPU."""
    from zraytrace_tpu_torch.dryrun import dryrun_multichip
    from zraytrace_tpu_torch.parallel.mesh import make_mesh

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            dryrun_multichip(1)
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh(device="cpu")
