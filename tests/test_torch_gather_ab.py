"""The gather and capability probes' new variants, their per-row bounds,
and their A/B tool (``zraytrace_tpu_torch/probes/gather_ab.py``), on the
CPU: the 2^20-lane and 8,192-row inputs (shapes, dtypes, seeds), the
plain versions against numpy at cut sizes, the bounds against sums
worked by hand, the tool's arguments, its refusal to run without a card
and its reading of ``cuobjdump -sass`` on a canned listing. The kernels
themselves are held to the plain versions on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py`` phase 14).
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from zraytrace_tpu_torch.probes import bounds, common, gather_ab, gather_probe3, pallas_probe

torch.set_num_threads(1)

CPU = torch.device("cpu")
N_1M = 1 << 20


def _listing(funcs: dict) -> str:
    """``cuobjdump -sass`` text for ``{name: [(offset, instruction)]}``."""
    lines = ["", "\tcode for sm_90a"]
    for name, instrs in funcs.items():
        lines.append(f"\t\tFunction : {name}")
        lines += [f"        /*{off:04x}*/                   {text} ;"
                  f"                  /* 0x000fe20000000000 */" for off, text in instrs]
    return "\n".join(lines) + "\n"


# a grid-stride loop storing four lanes a thread; a staging loop of copies,
# then a read loop of two shared loads a trip, then one store; a trip loop
# of four adds inside a loop storing four lanes; each function ends with
# the self-branch that pads it
LISTING = _listing({
    "_ZN12_GLOBAL__N_113philox_kernelEPKjPjij": [
        (0x00, "LDC R1, c[0x0][0x28]"), (0x10, "ISETP.GE.AND P0, PT, R0, UR4, PT"),
        (0x20, "@P0 BRA 0x90"), (0x30, "LDG.E.128.CONSTANT R4, desc[UR6][R2.64]"),
        (0x40, "IMAD.WIDE.U32 R6, R4, UR8, RZ"), (0x50, "LOP3.LUT R8, R7, UR9, R5, 0x96, !PT"),
        (0x60, "STG.E.128 desc[UR6][R10.64], R8"), (0x70, "ISETP.GE.AND P0, PT, R0, UR4, PT"),
        (0x80, "@!P0 BRA 0x30"), (0x90, "EXIT"), (0xa0, "BRA 0xa0")],
    "_ZN12_GLOBAL__N_115dg0_slab_kernelILi8EEEvPKfPKiPfiii": [
        (0x00, "LDGSTS.E [R2], desc[UR6][R4.64]"), (0x10, "@P0 BRA 0x0"),
        (0x20, "LDS R4, [R5]"), (0x30, "LDS R6, [R7+0x20]"), (0x40, "FADD R8, R8, R4"),
        (0x50, "FADD R9, R9, R6"), (0x60, "IADD3 R5, R5, 0x40, RZ"), (0x70, "@P1 BRA 0x20"),
        (0x80, "STG.E desc[UR6][R2.64], R8"), (0x90, "EXIT"), (0xa0, "BRA 0xa0")],
    "_ZN12_GLOBAL__N_112while_kernelEPKfPfii": [
        (0x00, "LDG.E.128.CONSTANT R4, desc[UR6][R2.64]"), (0x10, "FADD R8, R8, R4"),
        (0x20, "FADD R9, R9, R5"), (0x30, "FADD R10, R10, R6"), (0x40, "FADD R11, R11, R7"),
        (0x50, "IADD3 R12, R12, 0x1, RZ"), (0x60, "ISETP.GE.AND P0, PT, R12, UR4, PT"),
        (0x70, "@!P0 BRA 0x10"), (0x80, "STG.E.128 desc[UR6][R14.64], R8"),
        (0x90, "IADD3 R0, R0, UR5, RZ"), (0xa0, "@P1 BRA 0x0"), (0xb0, "EXIT"),
        (0xc0, "BRA 0xc0")],
})


def _funcs():
    return gather_ab.body_ab.parse_sass(LISTING)


# -- the new variants' inputs ------------------------------------------------


@pytest.mark.parametrize("variant", pallas_probe.VARIANTS)
def test_pallas_variants_inputs(variant):
    """The ``_1m`` variants are the tool's five at 2^20 lanes (8,192 rows
    of 128), drawn as the tool's are: the gathers' ids the first draw of
    ``default_rng(0)`` in [0, 4,096), then the table; the loop's ``x``
    the first draw; the counters the lane index; the same seeds and trip
    count."""
    mode, rows = pallas_probe.SHAPES[variant]
    assert rows == (pallas_probe.R_1M if variant.endswith("_1m") else pallas_probe.R)
    assert mode == pallas_probe.SHAPES[variant.removesuffix("_1m")][0]
    got_mode, x, idx, param = pallas_probe.make_inputs(variant, CPU)
    assert got_mode == mode
    rng = np.random.default_rng(0)
    if mode == "while":
        assert param == pallas_probe.TRIPS == 10 and idx is None
        assert x.dtype == torch.float32 and x.shape == (rows, 128)
        np.testing.assert_array_equal(x.numpy(), rng.random((rows, 128)).astype(np.float32))
    elif mode in ("gather1d", "gather2d"):
        assert param == 0 and idx.dtype == torch.int32 and idx.shape == (rows, 128)
        np.testing.assert_array_equal(idx.numpy(), rng.integers(0, 4096, (rows, 128)))
        assert x.numel() == pallas_probe.TABLE and x.dtype == torch.float32
        np.testing.assert_array_equal(x.numpy().reshape(-1), rng.random(4096).astype(np.float32))
        assert x.shape == ((32, 128) if mode == "gather2d" else (4096,))
    else:
        assert param == (7 if mode == "philox" else 42) and idx is None
        assert x.dtype == torch.int32 and x.shape == (rows, 128)
        assert torch.equal(x.reshape(-1), torch.arange(rows * 128, dtype=torch.int32))


def test_tex128_8192_inputs():
    """``tex128_8192``: an int32 (8,192, 128) table of 24-bit values and
    q, c drawn after it from ``default_rng(0)``, in [0, 8,192) and [0,
    128): 2^20 fetches from a 4 MB table."""
    mode, tbl, q, c = gather_probe3.make_inputs("tex128_8192", CPU)
    assert mode == "tex" and gather_probe3.SHAPES["tex128_8192"] == ("tex", 8192)
    for t in (tbl, q, c):
        assert t.dtype == torch.int32 and t.shape == (8192, 128)
    rng = np.random.default_rng(0)
    np.testing.assert_array_equal(tbl.numpy(), rng.integers(0, 1 << 24, (8192, 128)))
    np.testing.assert_array_equal(q.numpy(), rng.integers(0, 8192, (8192, 128)))
    np.testing.assert_array_equal(c.numpy(), rng.integers(0, 128, (8192, 128)))
    assert tbl.numel() * 4 == 4 << 20


def test_gather3_rows_override():
    """``make_inputs(..., rows=R)`` draws a variant's inputs at R rows
    (the card tests' 1 to 65,536): dg0's ids in [0, R)."""
    mode, tbl, idx, idx2 = gather_probe3.make_inputs("dg0_1024", CPU, rows=16)
    assert mode == "dg0" and tbl.shape == idx.shape == (16, 128) and idx2 is None
    assert int(idx.min()) >= 0 and int(idx.max()) < 16


# -- the plain versions against numpy ---------------------------------------


@pytest.mark.parametrize("rows", [1, 16])
def test_gather3_plain_matches_numpy(rows):
    """dg0 and dg1 (rounds in order, each add rounded to f32) and tex at a
    cut size, on ids of any int32 value."""
    rng = np.random.default_rng(5)
    tbl = rng.random((rows, 128)).astype(np.float32)
    idx = rng.integers(-2**31, 2**31 - 1, (rows, 128)).astype(np.int32)
    for axis, mode in ((0, "dg0"), (1, "dg1")):
        want = np.zeros((rows, 128), np.float32)
        for i in range(5):
            ix = (idx.astype(np.int64) + i) & ((rows if axis == 0 else 128) - 1)
            want = (want + np.take_along_axis(tbl, ix, axis)).astype(np.float32)
        got = gather_probe3.gather3_plain(mode, torch.from_numpy(tbl), torch.from_numpy(idx),
                                          rounds=5)
        np.testing.assert_array_equal(got.numpy(), want)
    itbl = rng.integers(0, 1 << 24, (rows, 128)).astype(np.int32)
    q = rng.integers(-1000, 1000, (rows, 128)).astype(np.int32)
    c = rng.integers(-1000, 1000, (rows, 128)).astype(np.int32)
    got = gather_probe3.gather3("tex", torch.from_numpy(itbl), torch.from_numpy(q),
                                torch.from_numpy(c))
    np.testing.assert_array_equal(got.numpy(), itbl[q & (rows - 1), c & 127])


def _np_pcg4d_x(px, seed):
    """uniform4(seed ^ STREAM_SCATTER, px, 3, 1).x in numpy uint32."""
    m, a = np.uint32(1664525), np.uint32(1013904223)
    with np.errstate(over="ignore"):
        x, y, z, w = (np.asarray(v, np.uint32) * m + a for v in (
            px, np.full_like(px, 3), np.full_like(px, 1),
            np.full_like(px, seed ^ 0x85EBCA6B)))
        x = x + y * w
        y = y + z * x
        z = z + x * y
        w = w + y * z
        x, y, z, w = (v ^ (v >> np.uint32(16)) for v in (x, y, z, w))
        x = x + y * w
    return (x >> np.uint32(8)).astype(np.float32) * np.float32(1.0 / 16777216.0)


def test_pallas_plain_matches_numpy():
    """The loop's sum, the gathers, Philox's first word and PCG4D's x on
    1,001 lanes against numpy (Philox: ``test_torch_probes2``'s numpy
    Philox4x32-10, checked there against the Random123 vectors)."""
    from test_torch_probes2 import _np_philox4x32_10

    rng = np.random.default_rng(9)
    n = 1001
    x = rng.random(n).astype(np.float32)
    want = np.zeros(n, np.float32)
    for _ in range(7):
        want = (want + x).astype(np.float32)
    got = pallas_probe.pallas_kernel("while", torch.from_numpy(x), None, 7)
    np.testing.assert_array_equal(got.numpy(), want)
    tbl = rng.random(4096).astype(np.float32)
    ids = rng.integers(-10000, 10000, n).astype(np.int32)
    for mode in ("gather1d", "gather2d"):
        got = pallas_probe.pallas_kernel(mode, torch.from_numpy(tbl), torch.from_numpy(ids))
        np.testing.assert_array_equal(got.numpy(), tbl[ids & 4095])
    lanes = np.arange(n, dtype=np.uint64) * 7919
    zeros = np.zeros_like(lanes)
    got = pallas_probe.pallas_kernel("philox", torch.from_numpy(lanes.astype(np.int32)), None, 7)
    want = _np_philox4x32_10([lanes, zeros, zeros, zeros], (7, 0))[0]
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    got = pallas_probe.pallas_kernel("pcg4d", torch.from_numpy(lanes.astype(np.int32)), None, 42)
    np.testing.assert_array_equal(got.numpy(), _np_pcg4d_x(lanes.astype(np.uint32), 42))


# -- the bounds ---------------------------------------------------------------


def test_generator_operation_counts():
    """Philox4x32-10's first word: 70 of the rounds' 80 operations and 17
    of the key schedule's 18 adds; PCG4D's x: seeds 8, mixing 8,
    xor-shifts 8, x's second update 2, the shift and conversion 2."""
    assert bounds.PHILOX_X_INT_OPS == 87 and bounds.PCG4D_X_INT_OPS == 28


def test_gather3_row_bounds_match_hand_sums():
    """Bytes at 3.35 TB/s against adds at 67 TFLOP/s: dg0 at 1,024 rows
    (table, ids, output: 12 x 131,072 B; 32 adds an element) 0.00047 ms,
    bytes; at 4,096 rows 0.00188; tex128 at 1,024 and 8,192 rows (table,
    q, c, output) 0.00063 and 0.00501; a roll reads x and writes out."""
    n = 1024 * 128
    w = gather_probe3.work("dg0", 1024)
    assert w == dict(flops=32 * n, nbytes=12 * n, int_ops=0)
    b, by = bounds.bound(w["flops"], w["nbytes"])
    assert by == "bytes" and b == pytest.approx(12 * n / 3.35e12 * 1e3)
    assert round(b, 5) == 0.00047
    assert round(bounds.bound(**_pos(gather_probe3.work("dg0", 4096)))[0], 5) == 0.00188
    assert round(bounds.bound(**_pos(gather_probe3.work("tex", 1024)))[0], 5) == 0.00063
    assert round(bounds.bound(**_pos(gather_probe3.work("tex", 8192)))[0], 5) == 0.00501
    assert gather_probe3.work("roll", 1024) == dict(flops=32 * n, nbytes=8 * n, int_ops=0)
    assert gather_probe3.work("dg1", 1024, rounds=5)["flops"] == 5 * n


def _pos(w):
    return dict(flops=w["flops"], nbytes=w["nbytes"], int_ops=w["int_ops"])


def test_pallas_row_bounds_match_hand_sums():
    """At 2^20 lanes every row is bound by its 8 MB (2.50 us; the gathers
    add the 16 KB table): Philox's 87 int32 operations a lane priced at
    the FP32 rate take 1.36 us, PCG4D's 28 and its multiply 0.45, the
    loop's 10 adds 0.16; at the tool's 8,192 lanes 0.0000196 ms."""
    for mode, ops_us in (("philox", 87), ("pcg4d", 29), ("while", 10)):
        w = pallas_probe.work(mode, N_1M, 10)
        assert w["flops"] + w["int_ops"] == ops_us * N_1M
        b, by = bounds.bound(**_pos(w))
        assert by == "bytes" and b == pytest.approx(8 * N_1M / 3.35e12 * 1e3)
    assert bounds.bound(0, 0, int_ops=87 * N_1M)[0] == pytest.approx(0.0013616, abs=1e-7)
    w = pallas_probe.work("gather1d", N_1M, 0)
    assert w["nbytes"] == 8 * N_1M + 4 * 4096
    assert bounds.bound(**_pos(pallas_probe.work("philox", 8192, 7)))[0] == pytest.approx(
        65536 / 3.35e12 * 1e3)
    assert bounds.unfused_ms(10 * N_1M) == pytest.approx(10 * N_1M / 33.5e12 * 1e3)


def test_rows_carry_their_bounds_on_the_host():
    """On the host each row carries its bound (no time, no floor)."""
    rows = gather_probe3.measure(CPU, ["tex128_8192", "vmem_48k"])
    assert rows[0]["bound_by"] == "bytes" and round(rows[0]["bound_ms"], 5) == 0.00501
    assert rows[0]["ms"] is None and "floor_ms" not in rows[0]
    assert rows[1]["bound_ms"] == pytest.approx(1024 / 3.35e12 * 1e3)
    row = pallas_probe.measure(CPU, ["pcg4d_parity"])[0]
    assert row["bound_by"] == "bytes" and row["bound_ms"] == pytest.approx(
        8 * 8192 / 3.35e12 * 1e3)


# -- the tool -----------------------------------------------------------------


def test_arguments_and_no_card():
    """``--parent`` repeats; an unknown option or a variant name is
    refused; without a CUDA device the tool says so and returns 2."""
    assert gather_ab.parse_args(["--parent", "a", "--parent", "b/c"]).parent == [Path("a"),
                                                                                Path("b/c")]
    assert gather_ab.parse_args([]).parent == []
    for argv in (["--bogus"], ["dg0_1024"], ["--parent"]):
        with pytest.raises(SystemExit):
            gather_ab.parse_args(argv)
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    assert gather_ab.main([]) == 2


def test_sass_loads_and_stored_lanes():
    """Table loads count ``LDS`` and ``LDG``, not the copies ``LDGSTS``;
    a 16-byte store writes four 4-byte lanes; the self-branch that pads
    a function is no loop."""
    funcs = _funcs()
    slab = funcs["_ZN12_GLOBAL__N_115dg0_slab_kernelILi8EEEvPKfPKiPfiii"]
    loops = gather_ab._loops(slab)
    assert [(lp["head"], lp["tail"]) for lp in loops] == [(0x20, 0x70), (0x0, 0x10)]
    assert loops[0]["hot_loads"] == 2 and loops[0]["hot_store_lanes"] == 0
    assert loops[1]["hot_loads"] == 0
    assert gather_ab._store_lanes([(0, "STG.E.128", None, ""), (0, "STG.E", None, ""),
                                   (0, "STG.E.64", None, "")]) == 7


def test_issue_instructions_models():
    """A read loop of 6 instructions and 2 loads runs n x rounds / 32 / 2
    warp-trips; a grid-stride loop of 6 storing 4 lanes n / 128; a trip
    loop of 7 (4 adds: one a lane) inside a loop of 11 storing 4 lanes
    (11 + 7 x (trips - 1)) x n / 128."""
    funcs = _funcs()
    n = 1 << 20
    slab = funcs["_ZN12_GLOBAL__N_115dg0_slab_kernelILi8EEEvPKfPKiPfiii"]
    assert gather_ab.issue_instructions(slab, "dg0_4096", n, rounds=32) == 6 * n * 32 / 32 / 2
    philox = funcs["_ZN12_GLOBAL__N_113philox_kernelEPKjPjij"]
    assert gather_ab.issue_instructions(philox, "prng_1m", n) == 6 * n / 128
    loop = funcs["_ZN12_GLOBAL__N_112while_kernelEPKfPfii"]
    assert gather_ab.issue_instructions(loop, "while_loop_1m", n, trips=10) == (
        (11 + 7 * 9) * n / 128)
    assert gather_ab.issue_instructions(philox, "dg0_1024", n) is None  # no read loop
    report = {name: None for name in funcs}
    assert gather_ab.kernel_for(report, "dg0_4096").endswith("dg0_slab_kernelILi8EEEvPKfPKiPfiii")
    assert gather_ab.kernel_for(report, "prng_1m").endswith("philox_kernelEPKjPjij")
    assert gather_ab.kernel_for(report, "vmem_48k") is None


def test_bounds_rows_from_measured_times():
    """``bounds`` prices this build's rows: the floor beside the time, the
    bound from the row's work, the issue bound at the clock over the
    time."""
    funcs = _funcs()
    report = {name: {"instrs": instrs} for name, instrs in funcs.items()}
    w = pallas_probe.work("philox", N_1M, 7)
    rows = [dict(probe="pallas_probe", variant="prng_1m", build=b, ms=ms, work=w)
            for b, ms in (("parent", 0.0046), (common.THIS, 0.003), (gather_ab.FLOOR, 0.0015))]
    out = gather_ab.bounds(report, rows, 1.98e9)[("pallas_probe", "prng_1m")]
    assert out["ms"] == 0.003 and out["floor_ms"] == 0.0015 and out["bound_by"] == "bytes"
    assert out["issue_instr"] == 6 * N_1M / 128
    assert out["bound_issue_ms"] == pytest.approx(6 * N_1M / 128 / (528 * 1.98e9) * 1e3)
    assert out["issue_share"] == pytest.approx(out["bound_issue_ms"] / 0.003)
    assert out["bound_unfused_ms"] == pytest.approx(87 * N_1M / 2 / 33.5e12 * 1e3)


def test_gather_ab_imports_no_jax():
    """The tool imports torch and the port, never JAX or the JAX package."""
    tree = ast.parse(Path(gather_ab.__file__).read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module or "" for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
    assert names and not [n for n in names if n.split(".")[0] in ("jax", "zraytrace_tpu")]
