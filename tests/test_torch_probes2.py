"""The port's last four probe micro-benchmarks (``pallas_probe``,
``gather_probe3``, ``overlap_probe``, ``flash2_probe`` in
``zraytrace_tpu_torch/probes/``) against the TPU tools they port, on the
CPU.

Each case captures the tool's Pallas kernel (the tool's ``pl`` is replaced
by a namespace whose ``pallas_call`` records the kernel and its
arguments), runs it in interpret mode at cut sizes on numpy inputs drawn
from a seed, and holds the port's plain version to it on the same inputs.
``tools/overlap_probe.py`` runs its benchmark at import, so its kernel is
taken from the source with ``ast``. Tolerances:

- integers, gathers, rolls and the loop's sums: equal;
- ``prng``: the TPU's hardware generator (``pltpu.prng_seed``) has no
  lowering on the CPU, so the port's Philox4x32-10 is held bit for bit to
  an independent numpy Philox, itself checked against the published
  known-answer vectors, and each of its 32 bits is set in 50% +- 2% of the
  8,192 draws;
- ``pcg4d_parity``: equal to JAX's ``rng.uniform4`` bit for bit;
- ``mm``, ``mm128``, ``mm_elem``, the block cull: relative 1e-5 on the
  sums and t, since XLA's CPU dot sums in its own order and contracts
  multiply-adds (ROADMAP Queue 3 (b2)); ``mm_elem``'s ids equal wherever
  the runner-up lies more than 1e-5 away; hit masks equal;
- overlap: relative 1e-5 (XLA's ``sin`` is a last-ulp approximation).

The kernels themselves are held to these plain versions on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py`` phase 14).
"""

import ast
import importlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from zraytrace_tpu import rng as jrng
from zraytrace_tpu_torch.probes import flash2_probe, gather_probe3, overlap_probe, pallas_probe

from torch_jax_native import jax_native  # noqa: F401  (an autouse fixture)

torch.set_num_threads(1)

CPU = torch.device("cpu")
ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def tools():
    """The tools imported without their persistent XLA cache (two enable
    it at import for the TPU's remote compiler)."""
    import zraytrace_tpu.runtime as runtime

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(runtime, "enable_compilation_cache", lambda *a, **k: None)
        return {name: importlib.import_module(f"tools.{name}")
                for name in ("pallas_probe", "gather_probe3", "flash2_probe")}


class _Captured(Exception):
    pass


class _CapturingPallas:
    """Stands in for a tool's ``pl``: ``pallas_call`` records its kernel
    and arguments and stops the tool; everything else is Pallas's own."""

    def __init__(self):
        self.kernel, self.kw = None, None

    def __getattr__(self, name):
        return getattr(pl, name)

    def pallas_call(self, kernel, **kw):
        self.kernel, self.kw = kernel, kw
        raise _Captured


def _capture(tool, monkeypatch, probe):
    """The kernel and arguments of the first ``pallas_call`` ``probe()``
    makes, as a function that runs it in interpret mode (``over`` replaces
    arguments)."""
    cap = _CapturingPallas()
    monkeypatch.setattr(tool, "pl", cap)
    with pytest.raises(_Captured):
        probe()

    def run(*args, **over):
        kw = {**cap.kw, "interpret": True, **over}
        return np.asarray(pl.pallas_call(cap.kernel, **kw)(*args))

    return run


# -- pallas_probe ----------------------------------------------------------

PALLAS_PROBES = {"while_loop": "probe_while_loop", "vmem_gather_1d": "probe_vmem_gather",
                 "vmem_gather_2d_reshape": "probe_vmem_gather_2d",
                 "pcg4d_parity": "probe_int_hash"}


@pytest.mark.parametrize("variant", list(PALLAS_PROBES))
def test_pallas_variant_matches_tool(tools, monkeypatch, variant):
    tool = tools["pallas_probe"]
    run = _capture(tool, monkeypatch, getattr(tool, PALLAS_PROBES[variant]))
    mode, x, idx, param = pallas_probe.make_inputs(variant, CPU)
    if mode == "pcg4d":
        want = run(jnp.asarray(x.numpy().astype(np.uint32)))
        ref = np.asarray(jrng.uniform4(param, jnp.arange(x.numel(), dtype=jnp.uint32)
                                       .reshape(x.shape), 3, 1, jrng.STREAM_SCATTER)[..., 0])
        np.testing.assert_array_equal(want, ref)
    elif idx is None:
        assert param == 10  # the tool's trip count
        want = run(jnp.asarray(x.numpy()))
    else:
        want = run(jnp.asarray(x.numpy()), jnp.asarray(idx.numpy()))
    got = pallas_probe.pallas_kernel(mode, x, idx, param)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def _np_philox4x32_10(ctr, key):
    """Philox4x32-10 in numpy uint64 (a 32x32-bit product fits), from the
    published constants (Salmon et al., SC'11)."""
    m = np.uint64(0xFFFFFFFF)
    c = [np.asarray(v, np.uint64) for v in ctr]
    k0, k1 = np.uint64(key[0]), np.uint64(key[1])
    for r in range(10):
        if r:
            k0, k1 = (k0 + np.uint64(0x9E3779B9)) & m, (k1 + np.uint64(0xBB67AE85)) & m
        p0 = np.uint64(0xD2511F53) * c[0]
        p1 = np.uint64(0xCD9E8D57) * c[2]
        c = [(p1 >> np.uint64(32)) ^ c[1] ^ k0, p1 & m, (p0 >> np.uint64(32)) ^ c[3] ^ k1, p0 & m]
    return [v.astype(np.uint32) for v in c]


def test_pallas_prng_is_philox():
    """The port's on-chip generator is Philox4x32-10: its plain version
    equals a numpy Philox (itself equal to the Random123 known-answer
    vectors) bit for bit, and its bits are balanced. The tool's kernel
    cannot run here: ``prng_seed`` has no CPU lowering."""
    kat = [((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
           ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
            (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
           ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
            (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1))]
    for ctr, key, want in kat:
        assert [int(v[0]) for v in _np_philox4x32_10([[c] for c in ctr], key)] == list(want)
    mode, ctr, _, seed = pallas_probe.make_inputs("prng", CPU)
    assert seed == 7
    got = pallas_probe.pallas_kernel(mode, ctr, None, seed)
    assert got.dtype == torch.int32 and got.shape == (64, 128)
    lanes = ctr.numpy().reshape(-1).astype(np.uint64)
    zeros = np.zeros_like(lanes)
    want = _np_philox4x32_10([lanes, zeros, zeros, zeros], (seed, 0))[0]
    np.testing.assert_array_equal(got.numpy().reshape(-1).view(np.uint32), want)
    share = ((want[:, None] >> np.arange(32, dtype=np.uint32)) & 1).mean(axis=0)
    assert np.all(np.abs(share - 0.5) <= 0.02), share


# -- gather_probe3 ---------------------------------------------------------

GATHER_K = 4


@pytest.mark.parametrize("variant", ["dg0_1024", "dg0_4096", "dg1_1024", "roll_1024",
                                     "roll_dyn_1024"])
def test_gather3_variant_matches_tool(tools, monkeypatch, variant):
    tool = tools["gather_probe3"]
    monkeypatch.setattr(tool, "K", GATHER_K)
    mode, rows = gather_probe3.SHAPES[variant]
    probe = (tool.probe_dg(rows, 0 if mode == "dg0" else 1) if mode.startswith("dg")
             else tool.probe_roll(rows, dynamic=mode == "roll_dyn"))
    run = _capture(tool, monkeypatch, probe)
    _, tbl, idx, _ = gather_probe3.make_inputs(variant, CPU)
    args = [jnp.asarray(tbl.numpy())] + ([] if idx is None else [jnp.asarray(idx.numpy())])
    got = gather_probe3.gather3(mode, tbl, idx, rounds=GATHER_K)
    np.testing.assert_array_equal(got.numpy(), run(*args))


def test_gather3_tex128_matches_tool(tools):
    """tex128: the tool's 128-round rotate-gather and the port's direct
    gather agree on the tool's (1024, 128) inputs."""
    tool = tools["gather_probe3"]
    mode, tbl, q, c = gather_probe3.make_inputs("tex128_1024", CPU)
    rows = tbl.shape[0]
    want = pl.pallas_call(
        tool._tex128_kernel(rows), out_shape=jax.ShapeDtypeStruct((rows, 128), jnp.int32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * 3,
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM), interpret=True,
    )(*(jnp.asarray(x.numpy()) for x in (tbl, q, c)))
    got = gather_probe3.gather3(mode, tbl, q, c)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), tbl.numpy()[q.numpy(), c.numpy()])


def test_gather3_vmem_matches_tool(tools, monkeypatch):
    """The scratch probe: the tool's kernel with 1 MB of scratch and the
    port's plain version both return 3.0 in every lane."""
    tool = tools["gather_probe3"]
    run = _capture(tool, monkeypatch, tool.probe_vmem(1))
    want = run(jnp.ones((8, 128), jnp.float32))
    got = gather_probe3.scratch(torch.ones(128), 1 << 20)
    np.testing.assert_array_equal(got.numpy(), want[0])
    assert np.all(want == 3.0)


def test_gather3_xla_gather_row():
    """The library row computes the tool's ``sum_K tbl[(idx + i) % F][:,
    0]``."""
    rng = np.random.default_rng(0)
    tbl = rng.random((1000, 3)).astype(np.float32)
    idx = rng.integers(0, 1000, 256)
    got = gather_probe3.library_xla_gather(torch.from_numpy(tbl), torch.from_numpy(idx), rounds=5)
    want = np.zeros(256, np.float32)
    for i in range(5):
        want = want + tbl[(idx + i) % 1000][:, 0]
    np.testing.assert_array_equal(got.numpy(), want)


# -- overlap_probe ---------------------------------------------------------

OVERLAP_ITERS = 16


def _overlap_tool_source():
    """The tool's ``_kernel`` and module constants, read from its source
    (importing it would run its benchmark)."""
    tree = ast.parse((ROOT / "tools" / "overlap_probe.py").read_text())
    consts, kernel = {}, None
    for node in tree.body:
        if isinstance(node, ast.FunctionDef) and node.name == "_kernel":
            kernel = node
        elif (isinstance(node, ast.Assign) and len(node.targets) == 1
              and isinstance(node.targets[0], ast.Name) and node.targets[0].id.isupper()):
            consts[node.targets[0].id] = node.value
    return consts, kernel


def test_overlap_kernel_matches_tool():
    consts, kernel = _overlap_tool_source()
    values = {}
    for name, node in consts.items():
        values[name] = eval(compile(ast.Expression(node), "overlap_probe", "eval"), {}, values)
    assert {k: values[k] for k in ("L", "N", "F", "REPS", "ITERS")} == dict(
        L=overlap_probe.L, N=overlap_probe.N, F=overlap_probe.F, REPS=overlap_probe.REPS,
        ITERS=overlap_probe.ITERS)
    namespace = {"jax": jax, "jnp": jnp, "ITERS": OVERLAP_ITERS}
    exec(compile(ast.Module([kernel], type_ignores=[]), "overlap_probe", "exec"), namespace)
    x, _, _ = overlap_probe.make_inputs(CPU)
    want = pl.pallas_call(
        namespace["_kernel"], out_shape=jax.ShapeDtypeStruct(x.shape, jnp.float32), grid=(8,),
        in_specs=[pl.BlockSpec((128, 128), lambda i: (i, 0))],
        out_specs=pl.BlockSpec((128, 128), lambda i: (i, 0)), interpret=True,
    )(jnp.asarray(x.numpy()))
    got = overlap_probe.overlap_kernel(x, iters=OVERLAP_ITERS)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    assert not np.allclose(got.numpy(), x.numpy())  # the iterations moved the values


# -- flash2_probe ----------------------------------------------------------

MM_R, MM_G, MM_REPS = 64, 64, 2


def _cut_flash2(tool, monkeypatch):
    monkeypatch.setattr(tool, "R", MM_R)
    monkeypatch.setattr(tool, "G", MM_G)
    monkeypatch.setattr(tool, "REPS", MM_REPS)


@pytest.mark.parametrize("variant", ["mm", "mm128"])
def test_flash2_mm_matches_tool(tools, monkeypatch, variant):
    tool = tools["flash2_probe"]
    _cut_flash2(tool, monkeypatch)
    run = _capture(tool, monkeypatch, getattr(tool, f"probe_{variant}"))
    k = flash2_probe.K128 if variant == "mm128" else flash2_probe.K
    lhs, rhs = flash2_probe.make_mm_inputs(CPU, k, cols=4 * MM_G, rows=MM_R)
    want = run(jnp.asarray(lhs.numpy()), jnp.asarray(rhs.numpy()))
    out, chk = flash2_probe.mm(lhs, rhs, reps=MM_REPS)
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-5)
    # the checksum: XOR over reps and columns of each product's bits,
    # rotated by the rep, from numpy's separately rounded products
    p = lhs.numpy()[:, 0:1] * rhs.numpy()[0]
    for j in range(1, k):
        p = p + lhs.numpy()[:, j:j + 1] * rhs.numpy()[j]
    bits = np.bitwise_xor.reduce(p.view(np.uint32), axis=1)
    want_chk = bits.copy()  # rep 0: no rotation
    for rep in range(1, MM_REPS):
        want_chk ^= (bits << np.uint32(rep)) | (bits >> np.uint32(32 - rep))
    np.testing.assert_array_equal(chk.numpy().view(np.uint32), want_chk)


def test_flash2_mm_elem_matches_tool(tools, monkeypatch):
    tool = tools["flash2_probe"]
    _cut_flash2(tool, monkeypatch)
    run = _capture(tool, monkeypatch, tool.probe_mm_elem)
    lhs, rhs = flash2_probe.make_mm_inputs(CPU, cols=4 * MM_G, rows=MM_R)
    want = run(jnp.asarray(lhs.numpy()), jnp.asarray(rhs.numpy()))
    got = flash2_probe.mm_elem(lhs, rhs, reps=MM_REPS).numpy()
    hit = got[:, 0] < 1e38
    assert hit.any() and (~hit).any()
    np.testing.assert_array_equal(want[:, 0] < 1e38, hit)
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=1e-5)
    # ids: equal where the runner-up t lies more than 1e-5 (relative) away
    p = lhs.numpy().astype(np.float64) @ rhs.numpy().astype(np.float64)
    det, un, vn, tn = (p[:, b * MM_G:(b + 1) * MM_G] for b in range(4))
    u, v, t = un / det, vn / det, tn / det
    t = np.where((det >= 1e-6) & (t > 1e-3) & (u >= 0) & (v >= 0) & (u + v <= 1), t, np.inf)
    two = np.sort(t, axis=1)[:, :2]
    with np.errstate(invalid="ignore"):  # rows without a hit: inf - inf
        clear = hit & (two[:, 1] - two[:, 0] > 1e-5 * two[:, 0])
    assert clear.sum() > 0.9 * hit.sum()
    np.testing.assert_array_equal(got[clear, 1], want[clear, 1])
    np.testing.assert_array_equal(got[~hit, 1], 0.0)


@pytest.mark.parametrize("case", list(flash2_probe.TIE_CASES) + ["tool"])
def test_flash2_mm_elem_keyed_winner_matches_plain(case):
    """The kernel's keyed winner (the least ``(t bits, rep, triangle)`` key
    over triangles and reps), replayed on the host, equals the plain
    version on tie-heavy inputs: duplicated triangle columns, rows with no
    hit, all triangles equal, and the tool's inputs; each over the tool's
    16 identical reps, at g = 97 (a ragged last tile in the kernel)."""
    g = 97
    if case == "tool":
        lhs, rhs = flash2_probe.make_mm_inputs(CPU, cols=4 * g, rows=MM_R)
    else:
        lhs, rhs = flash2_probe.make_tie_inputs(case, CPU, rows=MM_R, g=g)
    want = flash2_probe.mm_elem_plain(lhs, rhs)
    got = flash2_probe.mm_elem_keyed(lhs, rhs)
    assert torch.equal(got, want)
    hit = want[:, 0] < 1e38
    assert hit.any()
    if case == "no_hit_rows":
        assert not hit[1::2].any() and torch.equal(want[~hit, 1], torch.zeros(int((~hit).sum())))
    if case in ("dup_columns", "all_equal"):  # every winner is the lower of equal triangles
        assert torch.equal(want[hit, 1] % (2 if case == "dup_columns" else g),
                           torch.zeros(int(hit.sum())))


@pytest.fixture(scope="module")
def jax_teapot_planes():
    """Scene 3's planes as the tool builds them (the JAX package's teapot,
    BVH order, ``pack_tri_planes``), and the BVH order."""
    from zraytrace_tpu.geometry.bvh import build_tri_bvh
    from zraytrace_tpu.ops.flash_intersect import pack_tri_planes
    from zraytrace_tpu.scenes import teapot_and_ball

    sc = teapot_and_ball().scene
    order = build_tri_bvh(sc.tri_a, sc.tri_b, sc.tri_c).prim_order
    return pack_tri_planes(sc.tri_a, sc.tri_b, sc.tri_c, order=order), np.asarray(order)


def _one_cull_block(rays: str):
    """512 rays of ``flash2_probe.cull_rays``' set ``rays``: the first
    block, or for ``camera`` the block of pixel rows 130-131, which
    reaches 12 of the 50 chunks."""
    rb = flash2_probe.RB
    if rays == "camera":
        o, d = flash2_probe.cull_rays(CPU, n=8 * rb)[rays]
        return o[5 * rb:6 * rb], d[5 * rb:6 * rb]
    return flash2_probe.cull_rays(CPU, n=rb)[rays]


@pytest.mark.parametrize("rays", flash2_probe.CULL_RAY_SETS)
def test_flash2_cullwhen_matches_tool(tools, monkeypatch, jax_teapot_planes, rays):
    """The tool's block-culled kernel, grid 1 (512 rays), against the
    port's plain version on the same planes and rays; the port packs the
    same bounds from the same BVH order."""
    tool = tools["flash2_probe"]
    run = _capture(tool, monkeypatch, tool.probe_cullwhen)
    jp, order = jax_teapot_planes
    planes, bounds = np.array(jp.planes), np.array(jp.bounds)
    tp = flash2_probe.cull_planes(CPU)
    assert tp.planes.shape == planes.shape == (18, 50, 128) and bounds.shape == (50, 8)
    np.testing.assert_array_equal(tp.bounds.numpy(), bounds)
    np.testing.assert_array_equal(tp.planes[17].numpy().reshape(-1)[:order.size], order)
    o, d = _one_cull_block(rays)
    want = run(jnp.asarray(planes), jnp.asarray(bounds), jnp.asarray(o.numpy()),
               jnp.asarray(d.numpy()), grid=(1,),
               out_shape=jax.ShapeDtypeStruct((flash2_probe.RB, 8), jnp.float32))[:, 0]
    t, visits = flash2_probe.flash_cull(torch.from_numpy(planes), torch.from_numpy(bounds), o, d)
    hit = t.numpy() < 1e38
    np.testing.assert_array_equal(want < 1e38, hit)
    np.testing.assert_allclose(t.numpy()[hit], want[hit], rtol=1e-5)
    if rays == "into":
        assert hit.sum() > 20 and visits.tolist() == [50]
    elif rays == "camera":
        assert hit.sum() > 100 and visits.tolist() == [12]
    else:
        assert not hit.any() and visits.tolist() == [0]


@pytest.mark.parametrize("rays", flash2_probe.CULL_RAY_SETS)
def test_flash2_cull_split_matches_plain(rays):
    """The kernel's schedule on the host (each reached chunk's triangles
    in 8 slices of 16, the slices' minima merged) equals the plain version
    in t and visits, bit for bit, on 8 blocks of each ray set; the camera
    set's blocks reach none, all or some of the 50 chunks."""
    tp = flash2_probe.cull_planes(CPU)
    o, d = flash2_probe.cull_rays(CPU, n=8 * flash2_probe.RB)[rays]
    t, visits = flash2_probe.flash_cull_split(tp.planes, tp.bounds, o, d)
    want_t, want_v = flash2_probe.flash_cull_plain(tp.planes, tp.bounds, o, d)
    assert torch.equal(t, want_t) and torch.equal(visits, want_v)
    if rays == "camera":
        assert visits.tolist() == [0, 0, 0, 0, 50, 12, 12, 12]
        assert bool((t[:4 * flash2_probe.RB] >= 1e38).all()) and bool((t < 1e38).any())
