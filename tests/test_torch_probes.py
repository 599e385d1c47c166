"""The port's probe micro-benchmarks (``zraytrace_tpu_torch/probes/``)
against the TPU tools they port, on the CPU.

For each of ``tools/rng_probe.py``, ``tools/inkernel_texel_probe.py``,
``tools/body_probe.py`` and ``tools/flash3_probe.py``, the tool's Pallas
kernel runs in interpret mode and the port's plain version takes the same
numpy inputs (drawn from a seed), at sizes cut with ``monkeypatch`` on the
tools' module constants. One case per variant. Tolerances:

- integer outputs: equal, but for ``f32mul``, which XLA folds into one
  multiply (relative 1e-4; its numpy replay, ten roundings, is equal);
- the texel gathers and the relayout chain: equal (separately rounded
  adds and multiplies in one order); ``e2e_atlas``: ``rtol = 1e-6``, the
  tool's own bar (its division by 255);
- ``flash3``: relative 1e-5 on the summed t (XLA's CPU backend contracts
  multiply-adds inside the kernel, ROADMAP Queue 3 (b2));
- ``body``: integer planes equal; float planes within ``atol = 1e-4`` plus
  ``rtol = 1e-4`` (XLA's contracted multiply-adds, its approximate rsqrt,
  sin and cos, carried through one or two body iterations).

The kernels themselves are held to these plain versions on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py`` phase 14).
"""

import ast
import importlib
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zraytrace_tpu import rng as jrng
from zraytrace_tpu_torch import vecmath as vm
from zraytrace_tpu_torch.probes import body_probe, common, flash2_probe, flash3_probe
from zraytrace_tpu_torch.probes import gather_probe3, inkernel_texel_probe, overlap_probe
from zraytrace_tpu_torch.probes import pallas_probe, rng_probe

torch.set_num_threads(1)

CPU = torch.device("cpu")
PROBES = ("rng_probe", "inkernel_texel_probe", "body_probe", "flash3_probe")
# every probe module; the last four are held to their tools in test_torch_probes2.py
MODULES = PROBES + ("pallas_probe", "gather_probe3", "overlap_probe", "flash2_probe")


@pytest.fixture(scope="module")
def tools():
    """The four TPU tools, imported without their persistent XLA cache
    (they enable it at import for the TPU's remote compiler)."""
    import zraytrace_tpu.runtime as runtime

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(runtime, "enable_compilation_cache", lambda *a, **k: None)
        return {name: importlib.import_module(f"tools.{name}") for name in PROBES}


# -- rng_probe -----------------------------------------------------------


@pytest.mark.parametrize("variant", rng_probe.VARIANTS)
def test_rng_variant_matches_tool(tools, monkeypatch, variant):
    tool = tools["rng_probe"]
    monkeypatch.setattr(tool, "R_TOT", 16)
    x = rng_probe.make_input(CPU, shape=(16, 128))
    want = np.asarray(tool.build(tool.VARIANTS[variant])(jnp.asarray(x.numpy())))
    got = rng_probe.rng_chain(x, variant, iters=tool.B)
    assert got.dtype == torch.int32
    if variant != "f32mul":
        np.testing.assert_array_equal(got.numpy(), want)
        return
    # XLA's algebraic simplifier folds the ten multiplies by 1.0001 into
    # one by 1.0010004 (its HLO shows a single multiply), rounding once
    # where the tool's code rounds ten times; over B iterations of
    # c + int(c * 1.001) that moves the result by up to ~2e-5 relative.
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4)
    # The port follows the code as written: numpy, ten f32 roundings.
    c = x.numpy().astype(np.int64)
    for _ in range(tool.B):
        u = c.astype(np.float32)
        for _ in range(10):
            u = u * np.float32(1.0001)
        c = c + u.astype(np.int32)
    np.testing.assert_array_equal(got.numpy(), c)


def test_rng_pcg4d_i32_self_check():
    """The tool's self-check: the int32 PCG4D equals the uint32 one, here
    the port's, and both equal the JAX package's ``rng.pcg4d``."""
    rng_probe.self_check(CPU)
    a = np.random.default_rng(5).integers(0, 2**32, (256,), dtype=np.uint32)
    ctr = jnp.stack([jnp.asarray(a), jnp.asarray(a + 1), jnp.asarray(a + 2),
                     jnp.full((256,), 42, jnp.uint32)], axis=-1)
    want = np.asarray(jrng.pcg4d(ctr))[:, 0] >> 8
    ai = torch.from_numpy(a.view(np.int32).astype(np.int64))
    w = rng_probe._w
    got = rng_probe._pcg4d_i32(ai, w(ai + 1), w(ai + 2), torch.full_like(ai, 42))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_rng_chain_folds_launches():
    """``chain`` launches folded into one equal that many chained launches."""
    x = rng_probe.make_input(CPU, shape=(2, 128))
    once = rng_probe.rng_chain(rng_probe.rng_chain(x, "pcg4d"), "pcg4d")
    assert torch.equal(rng_probe.rng_chain(x, "pcg4d", chain=2), once)


# -- inkernel_texel_probe ------------------------------------------------

TEXEL_K = 2
TEXEL_F = 4096
TEXEL_CASES = {
    "wide_dg1": ("dg1", dict(R=8, W=1024, NI=64)),
    "blk_dg1": ("dg1", dict(R=16, W=256, NI=128)),
    "row1_dg1": ("dg1", dict(R=1, W=TEXEL_F, NI=256)),
    "reshape_rt": ("reshape_rt", dict(R=8)),
    "e2e_atlas": ("e2e_atlas", dict(R=8)),
}


def _texel_tool_run(tool, monkeypatch, mode, kw):
    """Run one of the tool's probes in interpret mode; returns its kernel's
    (inputs, output), captured where the tool times them."""
    monkeypatch.setattr(tool, "INTERPRET", True)
    monkeypatch.setattr(tool, "K", TEXEL_K)
    monkeypatch.setattr(tool, "F_ATLAS", TEXEL_F)
    seen = []

    def capture(g, args, reps=3):
        seen.append(([np.asarray(a) for a in args], np.asarray(g(*args))))
        return 0.0, 1.0

    monkeypatch.setattr(tool, "_time", capture)
    if mode == "dg1":
        tool.probe_dg1(kw["R"], kw["W"], kw["NI"])()
    elif mode == "reshape_rt":
        tool.probe_reshape_rt(kw["R"])()
    else:
        tool.probe_e2e(kw["R"])()
    return seen[-1]


@pytest.mark.parametrize("case", list(TEXEL_CASES))
def test_texel_variant_matches_tool(tools, monkeypatch, case):
    mode, kw = TEXEL_CASES[case]
    args, want = _texel_tool_run(tools["inkernel_texel_probe"], monkeypatch, mode, kw)
    table = torch.from_numpy(args[0].copy())
    idx = torch.from_numpy(args[1].copy()) if len(args) > 1 else None
    if mode == "e2e_atlas":
        table = table.reshape(-1)  # the port's atlas is (F,), the tool's (1, F)
    got = inkernel_texel_probe.texel_gather(mode, table, idx, rounds=TEXEL_K).numpy()
    if mode == "e2e_atlas":
        np.testing.assert_allclose(got, want, rtol=1e-6)
        np.testing.assert_allclose(
            got, inkernel_texel_probe.numpy_e2e(args[0][0], args[1], TEXEL_K), rtol=1e-6)
    else:
        np.testing.assert_array_equal(got, want)


def test_texel_inputs_and_library_row():
    """The port draws e2e_atlas's inputs as the tool does, and the library
    row returns the unpacked texels of the ids it is given."""
    mode, table, idx = inkernel_texel_probe.make_inputs("e2e_atlas", CPU)
    rng = np.random.default_rng(0)
    np.testing.assert_array_equal(
        table.numpy(), rng.integers(0, 1 << 24, (1, inkernel_texel_probe.F_ATLAS))
        .astype(np.int32)[0])
    np.testing.assert_array_equal(
        idx.numpy(), rng.integers(0, inkernel_texel_probe.F_ATLAS, (64, 128)).astype(np.int32))
    rgb = torch.stack([((table >> s) & 255).to(torch.float32) / 255.0 for s in (16, 8, 0)], 1)
    ids = idx.reshape(-1)[:16].long()
    rows = inkernel_texel_probe.library_gather(rgb, ids)
    plain = inkernel_texel_probe.texel_gather_plain(mode, table, idx.reshape(-1)[:16][None],
                                                    rounds=1)
    np.testing.assert_allclose(rows.numpy().T, plain[:, 0].numpy(), rtol=1e-6)


def test_texel_channel_table_is_the_division():
    """The e2e_atlas kernel's channel table (c / 255 for c in 0..255, made
    once per device by the wrapper) equals the plain version's division
    (``vm.div``) and numpy's float32 c / 255, bit for bit."""
    table = inkernel_texel_probe.channel_table(CPU)
    c = torch.arange(256, dtype=torch.float32)
    assert table.dtype == torch.float32 and table.shape == (256,)
    assert torch.equal(table.view(torch.int32), vm.div(c, 255.0).view(torch.int32))
    want = np.arange(256, dtype=np.float32) / np.float32(255.0)
    np.testing.assert_array_equal(table.numpy().view(np.uint32), want.view(np.uint32))
    assert inkernel_texel_probe.channel_table("cpu") is table  # made once per device


# -- body_probe ----------------------------------------------------------

BODY_R = 16
BODY_ATOL = BODY_RTOL = 1e-4


@pytest.fixture(scope="module")
def body_inputs():
    return body_probe.make_inputs(CPU, shape=(BODY_R, 128))


@pytest.fixture(scope="module")
def jax_tables():
    """Scene 1's tables as the JAX package lays them out (equal, bit for
    bit, to the port's ``scene_tables``)."""
    from zraytrace_tpu.ops.common import prepare_tables
    from zraytrace_tpu.scenes import three_balls

    built = three_balls()
    return prepare_tables(built.scene, built.camera)


def _body_tool(tool, monkeypatch, variant, iters, inputs, tables):
    monkeypatch.setattr(tool, "R_TOT", BODY_R)
    monkeypatch.setattr(tool, "B", iters)
    state, base, _, params = inputs
    out = tool.build(tool.VARIANTS[variant])(
        jnp.asarray(params, jnp.int32), tables.cam, tables.spheres, tables.mats,
        jnp.asarray(base.numpy()), *(jnp.asarray(t.numpy()) for t in state))
    return [np.asarray(t) for t in out]


@pytest.mark.parametrize("variant,iters", [(v, 2) for v in body_probe.VARIANTS
                                           if v != "trig_libdevice"] + [("full", 1)])
def test_body_variant_matches_tool(tools, monkeypatch, body_inputs, jax_tables, variant,
                                   iters):
    want = _body_tool(tools["body_probe"], monkeypatch, variant, iters, body_inputs, jax_tables)
    state, base, tables, params = body_inputs
    for mine, theirs in zip(tables, (jax_tables.spheres, jax_tables.mats, jax_tables.cam)):
        np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs))
    got = body_probe.body_chain(variant, state, base, tables, params, iters=iters)
    assert len(got) == len(want) == 15
    for k, (g, w) in enumerate(zip(got, want)):
        if k >= body_probe.N_F32:
            np.testing.assert_array_equal(g.numpy(), w, err_msg=f"plane {k}")
        else:
            np.testing.assert_allclose(g.numpy(), w, rtol=BODY_RTOL, atol=BODY_ATOL,
                                       err_msg=f"plane {k}")
    if variant == "full":  # the body did work: paths ended and scattered
        assert not torch.equal(got[12], state[12]) and not torch.equal(got[13], state[13])


def test_body_trig_libdevice_matches_torch_trig(body_inputs):
    """The libdevice form computes acos/atan2 where ``trig`` runs the
    polynomials. Their core is Cephes atanf's polynomial, made for [0,
    tan(pi/8)] but applied on [0, 1] without the further reduction: at 1 it
    gives 0.8082 for atan(1) = 0.7854, so theta and phi differ from the
    library's by up to 0.023 rad, and sin(2 theta) by up to twice that."""
    state, base, tables, params = body_inputs
    poly = body_probe.body_chain("trig", state, base, tables, params, iters=1)
    lib = body_probe.body_chain("trig_libdevice", state, base, tables, params, iters=1)
    for k, atol in ((0, 0.05), (1, 0.025), (2, 0.025)):
        err = float((lib[k] - poly[k]).abs().max())
        assert 1e-4 < err < atol, (k, err)


# -- flash3_probe --------------------------------------------------------

FLASH_R, FLASH_NCHUNK, FLASH_REPS = 16, 3, 2


@pytest.mark.parametrize("mode", flash3_probe.MODES)
def test_flash3_mode_matches_tool(tools, monkeypatch, mode):
    """Each layout against the tool's run of the same mode; ``tile``, a
    layout the TPU tool does not have, against its ``base`` run, which
    computes the same sums."""
    tool = tools["flash3_probe"]
    monkeypatch.setattr(tool, "R", FLASH_R)
    monkeypatch.setattr(tool, "NCHUNK", FLASH_NCHUNK)
    monkeypatch.setattr(tool, "REPS", FLASH_REPS)
    seen = []

    def capture(x):
        seen.append(np.asarray(x))
        return 0.0

    monkeypatch.setattr(tool, "_force", capture)
    tool.run("base" if mode == "tile" else mode)
    want = seen[0]
    planes, o, d = flash3_probe.make_inputs(CPU, FLASH_R, FLASH_NCHUNK)
    got = flash3_probe.flash_body(mode, planes, o, d, reps=FLASH_REPS).numpy()
    hit = want < 1e30
    assert hit.any() and (~hit).any()  # some rays hit, some miss (sum inf)
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_allclose(got[hit], want[hit], rtol=1e-5)


@pytest.mark.parametrize("reps", [1, 2])
@pytest.mark.parametrize("nchunk", [1, 3])
@pytest.mark.parametrize("rays", [1, 37, 130])
def test_flash3_tile_twin_matches_plain(rays, nchunk, reps):
    """``tile``'s schedule on the host (rays padded to whole warps of 4,
    each lane's partial minimum per rep, merged, then summed) equals the
    plain version bit for bit, at ray counts that are not a multiple of
    the warp's 4 rays, on 1 and 3 chunks, over 1 and 2 reps."""
    planes, o, d = flash3_probe.make_inputs(CPU, rays, nchunk)
    got = flash3_probe.flash_body_tile_twin(planes, o, d, reps=reps)
    want = flash3_probe.flash_body_plain(planes, o, d, reps=reps)
    assert got.shape == (rays,) and torch.equal(got, want)
    if rays > 1:
        assert bool((want < 1e38).any()) and bool((want >= 1e38).any())


# -- the modules ---------------------------------------------------------


@pytest.mark.parametrize("module", ("common",) + MODULES)
def test_probe_module_imports_no_jax(module):
    """The port's probes import torch and the port, never JAX or the JAX
    package (their imports, read from the source)."""
    path = Path(common.__file__).with_name(f"{module}.py")
    names = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module or "")
    assert names and not [n for n in names if n.split(".")[0] in ("jax", "zraytrace_tpu")]


def test_probe_entry_needs_a_card_or_cpu(capsys):
    """Without ``--cpu`` a probe needs a CUDA device and raises without one;
    with it the plain versions run and print a line each."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="--cpu"):
        common.main_for(rng_probe.measure, rng_probe.VARIANTS, ["pcg4d"])
    with pytest.raises(ValueError, match="unknown variants"):
        common.main_for(rng_probe.measure, rng_probe.VARIANTS, ["--cpu", "nope"])
    assert common.main_for(rng_probe.measure, rng_probe.VARIANTS, ["--cpu", "pcg4d_i32"]) == 0
    assert "[plain] rng_probe pcg4d_i32" in capsys.readouterr().out


@pytest.mark.parametrize("module", MODULES)
def test_probe_wrapper_refuses_other_devices(module):
    """A wrapper runs its plain version only on the CPU: a tensor on
    another device is refused, not computed on the host."""
    meta = torch.device("meta")
    with pytest.raises(ValueError):
        if module == "rng_probe":
            rng_probe.rng_chain(torch.zeros(4, dtype=torch.int32, device=meta), "pcg4d")
        elif module == "inkernel_texel_probe":
            inkernel_texel_probe.texel_gather(
                "reshape_rt", torch.zeros((2, 4), device=meta), None)
        elif module == "body_probe":
            z = torch.zeros(4, device=meta)
            zi = torch.zeros(4, dtype=torch.int32, device=meta)
            body_probe.body_chain("pass_", [z] * 12 + [zi] * 3, zi, None, tuple(range(10)))
        elif module == "flash3_probe":
            flash3_probe.flash_body("base", torch.zeros((17, 1, 128), device=meta),
                                    torch.zeros((2, 3), device=meta),
                                    torch.zeros((2, 3), device=meta))
        elif module == "pallas_probe":
            pallas_probe.pallas_kernel("while", torch.zeros((2, 4), device=meta), None, 3)
        elif module == "gather_probe3":
            gather_probe3.gather3("roll", torch.zeros((2, 128), device=meta))
        elif module == "overlap_probe":
            overlap_probe.overlap_kernel(torch.zeros((2, 4), device=meta))
        else:
            flash2_probe.mm(torch.zeros((4, 16), device=meta), torch.zeros((16, 128), device=meta))
