"""The bounce-body and overlap probes' A/B tool
(``zraytrace_tpu_torch/probes/body_ab.py``) and the bounds it prices
(``probes/bounds.py``), on the CPU: its reading of ``cuobjdump -sass``
on a canned listing, its arguments, and the three bounds against sums
worked by hand. The tool itself times kernels and needs a CUDA device.
"""

import ast
from pathlib import Path

import pytest
import torch

from zraytrace_tpu_torch.probes import body_ab, body_probe, overlap_probe
from zraytrace_tpu_torch.probes.bounds import bound, issue_ms, unfused_ms

# cuobjdump -sass's layout: a header per function, then each instruction
# at its offset with its encoding, and a second encoding line. The loop
# runs 0x40 .. 0x140: a head with sinf's 2/pi multiply and its range test,
# a slow block storing to local memory (an inner loop, then a jump back),
# a fast block, a branch to a called slow path placed after the kernel's
# exit, a branch to an out-of-line fast block, and the join with the
# back-edge; after it, a subroutine and the trailing self-branch.
LISTING = """
Fatbin elf code:
================
arch = sm_90a
code version = [1,8]
host = linux
compile_size = 64bit

	code for sm_90a
		Function : _ZN12_GLOBAL__N_114overlap_kernelEPKfPfii
	.headerflags	@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                       /* 0x00000a00ff017b82 */
                                                                                /* 0x000fe20000000800 */
        /*0010*/                   ISETP.GE.AND P0, PT, R2, UR4, PT ;           /* 0x0000000402007c0c */
                                                                                /* 0x000fda000bf06270 */
        /*0020*/               @P0 EXIT ;                                       /* 0x000000000000094d */
                                                                                /* 0x000fea0003800000 */
        /*0030*/                   LDG.E.CONSTANT R3, desc[UR6][R4.64] ;        /* 0x0000000604037981 */
                                                                                /* 0x000ea2000c1e9900 */
        /*0040*/                   FMUL R0, R3.reuse, 0.63661974668502807617 ;  /* 0x3f22f98303007820 */
                                                                                /* 0x004fe20000400000 */
        /*0050*/                   FSETP.GE.AND P1, PT, |R3|, 105615, PT ;      /* 0x47ce47800300780b */
                                                                                /* 0x000fda0003f26200 */
        /*0060*/              @!P1 BRA 0x100 ;                                  /* 0x0000000000249947 */
                                                                                /* 0x000fea0003800000 */
        /*0070*/                   STL [R1], R11 ;                              /* 0x0000000b01007387 */
                                                                                /* 0x0001e40000100800 */
        /*0080*/               @P2 BRA 0x70 ;                                   /* 0xfffffffc00f82947 */
                                                                                /* 0x000fea000383ffff */
        /*0090*/                   BRA 0x100 ;                                  /* 0x0000000000187947 */
                                                                                /* 0x000fea0003800000 */
        /*0100*/                   FFMA R5, R4, -1.5707962512969970703, R3 ;    /* 0xbfc90fda04057823 */
                                                                                /* 0x000fe20000000003 */
        /*0110*/              @!P3 BRA 0x170 ;                                  /* 0x0000000000149947 */
                                                                                /* 0x000fea0003800000 */
        /*0120*/               @P4 BRA 0x1b0 ;                                  /* 0x0000000000204947 */
                                                                                /* 0x000fea0003800000 */
        /*0130*/                   FADD R3, R0, R3 ;                            /* 0x0000000300037221 */
                                                                                /* 0x000fc80000000000 */
        /*0140*/              @!P0 BRA 0x40 ;                                   /* 0xfffffffc00c08947 */
                                                                                /* 0x000fea000383ffff */
        /*0150*/                   STG.E desc[UR6][R4.64], R3 ;                 /* 0x0000000304007986 */
                                                                                /* 0x000fe2000c101906 */
        /*0160*/                   EXIT ;                                       /* 0x000000000000794d */
                                                                                /* 0x000fea0003800000 */
        /*0170*/                   MOV R2, R26 ;                                /* 0x0000001a00027202 */
                                                                                /* 0x000fe20000000f00 */
        /*0180*/                   CALL.REL.NOINC 0x1e0 ;                       /* 0x0000000000107944 */
                                                                                /* 0x000fea0003c00000 */
        /*0190*/                   BRA 0x130 ;                                  /* 0xfffffff800647947 */
                                                                                /* 0x000fea000383ffff */
        /*01a0*/                   NOP ;                                        /* 0x0000000000007918 */
                                                                                /* 0x000fc00000000000 */
        /*01b0*/                   FMUL R7, R7, R7 ;                            /* 0x0000000707077220 */
                                                                                /* 0x000fe20000400000 */
        /*01c0*/                   BRA 0x130 ;                                  /* 0xfffffff800587947 */
                                                                                /* 0x000fea000383ffff */
        /*01e0*/                   RET.REL.NODEC R20 0x0 ;                      /* 0xfffffe0014007950 */
                                                                                /* 0x000fea0003c3ffff */
        /*01f0*/                   BRA 0x1f0;                                   /* 0xfffffffc00fc7947 */
                                                                                /* 0x000fc0000383ffff */
		..........


		Function : _ZN12_GLOBAL__N_111body_kernelILi6EEEvPKf
	.headerflags	@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   MUFU.RCP R29, R26 ;                          /* 0x0000001a001d7308 */
                                                                                /* 0x000e620000001000 */
        /*0010*/                   FCHK P2, R0, R26 ;                           /* 0x0000001a00007302 */
                                                                                /* 0x000e640000040000 */
        /*0020*/                   EXIT ;                                       /* 0x000000000000794d */
                                                                                /* 0x000fea0003800000 */
"""


def _overlap():
    return body_ab.find_kernel(body_ab.parse_sass(LISTING), "overlap_kernel")


def test_sass_parser_reads_functions_and_instructions():
    """Both functions, every instruction once (the encoding lines and the
    header skipped), predicates stripped from the opcode but kept in the
    text, branch targets read; a name part must match one function."""
    funcs = body_ab.parse_sass(LISTING)
    assert len(funcs) == 2
    ins = _overlap()
    assert [off for off, *_ in ins][:5] == [0x0, 0x10, 0x20, 0x30, 0x40]
    assert len(ins) == 25
    by_off = {off: (op, t, text) for off, op, t, text in ins}
    assert by_off[0x60] == ("BRA", 0x100, "@!P1 BRA 0x100")
    assert by_off[0x20][0] == "EXIT" and by_off[0x180][0] == "CALL.REL.NOINC"
    assert by_off[0x1f0][:2] == ("BRA", 0x1f0)
    body = body_ab.find_kernel(funcs, "body_kernelILi6E")
    assert body_ab.count_ops(body) == {"all": 3, "MUFU": 1, "FCHK": 1}
    with pytest.raises(KeyError):
        body_ab.find_kernel(funcs, "_kernel")
    with pytest.raises(KeyError):
        body_ab.find_kernel(funcs, "flash_kernel")


def test_sass_opcode_counts():
    """Opcodes are counted by prefix (FMUL.FTZ as FMUL, CALL.REL.NOINC as
    CALL); ``all`` counts every instruction."""
    counts = body_ab.count_ops(_overlap())
    assert counts == {"all": 25, "FMUL": 2, "FSETP": 1, "FFMA": 1, "FADD": 1, "ISETP": 1,
                      "LDG": 1, "STG": 1, "BRA": 9, "CALL": 1}


def test_sass_loops_count_hot_paths():
    """The loop from 0x40 to its back-edge at 0x140: 16 instructions on
    its paths (the out-of-line call and fast blocks included, the
    unreachable NOP not); its hot path leaves out the local-memory block,
    the jump reached only through it and the called slow path: 10, one
    2/pi multiply. The slow block's own inner loop has no hot path; the
    trailing self-branch is a loop of one."""
    loops = body_ab.loops(_overlap())
    main = loops[0]
    assert (main["head"], main["tail"]) == (0x40, 0x140)
    assert main["ops"]["all"] == 16 and main["ops"]["CALL"] == 1
    assert main["hot"] == {"all": 10, "FMUL": 2, "FSETP": 1, "BRA": 5, "FFMA": 1, "FADD": 1}
    assert main["trip_iters"] == 1
    inner = next(lp for lp in loops if lp["head"] == 0x70)
    assert inner["ops"] == {"all": 2, "BRA": 1} and inner["hot"] == {}
    self_loop = next(lp for lp in loops if lp["head"] == 0x1f0)
    assert self_loop["ops"] == self_loop["hot"] == {"all": 1, "BRA": 1}
    # a trip of the overlap chain holds trip_iters iterations, a body's one
    sass = {k: {"loops": [dict(hot={"all": 185}, trip_iters=8)]} for k in ("overlap", "body_full")}
    assert body_ab.sass_per_iteration(sass, "overlap") == 185 / 8
    assert body_ab.sass_per_iteration(sass, "body_full") == 185


def test_arguments():
    """``--parent`` repeats; an unknown option or a variant name is
    refused; without a CUDA device the tool says so and returns 2."""
    assert body_ab.parse_args(["--parent", "a", "--parent", "b/c"]).parent == [Path("a"),
                                                                              Path("b/c")]
    assert body_ab.parse_args([]).parent == []
    for argv in (["--bogus"], ["full"], ["--parent"]):
        with pytest.raises(SystemExit):
            body_ab.parse_args(argv)
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    assert body_ab.main([]) == 2


def test_three_bounds_match_hand_sums():
    """The probes' bounds on the H100 (67 TFLOP/s FP32, 132 x 4
    schedulers): ``full`` at (325 + 80) operations a lane-iteration over
    1024 x 128 lanes and 8 iterations is 0.0063 ms; the overlap kernel at
    21 operations an element-iteration, 760 iterations, 0.0312 ms; at
    1.98 GHz, 42 warp instructions an iteration of the overlap chain take
    0.1251 ms at the issue rate, and 1,430 of ``full`` 0.0448 ms."""
    n = body_probe.R_TOT * body_probe.L
    assert body_probe.FULL_FP32_OPS == 325 and body_probe.FULL_INT_OPS == 80
    fp, iops = body_probe.full_ops(n)
    b_ms, by = bound(fp, body_probe.full_bytes(n), int_ops=iops)
    assert by == "operations" and b_ms == pytest.approx(405 * n * 8 / 67e12 * 1e3)
    assert round(b_ms, 4) == 0.0063
    m = overlap_probe.L * overlap_probe.ITERS
    assert round(bound(m * overlap_probe.ITER_FLOPS, 0)[0], 4) == 0.0312
    assert issue_ms(42 * 4096 * 760, 1.98e9) == pytest.approx(0.12506, abs=1e-5)
    assert issue_ms(1430 * 4096 * 8, 1.98e9) == pytest.approx(0.04482, abs=1e-5)
    # one instruction per multiply, add or fused multiply-add: sinf's 11
    # and the update's 3 for the chain; full's 325 operations with its
    # library calls at their fast paths' instructions
    assert overlap_probe.ITER_INSTRS == 14 and body_probe.FULL_FP32_INSTRS == 443
    assert unfused_ms(m * 14) == pytest.approx(m * 14 / 33.5e12 * 1e3)
    fpi, iops = body_probe.full_instructions(n)
    assert unfused_ms(fpi, iops) == pytest.approx((443 + 40) * n * 8 / 33.5e12 * 1e3)


def test_three_bounds_from_counted_sass():
    """``three_bounds`` prices each kernel from its loop's hot count: a
    trip of the overlap chain holds ``trip_iters`` iterations; the issue
    reading is what the measured time would issue at the clock."""
    sass = {"body_full": {"loops": [{"hot": {"all": 1430}, "trip_iters": 2}]},
            "overlap": {"loops": [{"hot": {"all": 42 * 8}, "trip_iters": 8}]}}
    out = body_ab.three_bounds(sass, 1.98e9, {"probe_body": 0.04482154882154882,
                                              "probe_overlap": 0.1263})
    body, ov = out["probe_body"], out["probe_overlap"]
    assert body["sass_per_iter"] == 1430 and ov["sass_per_iter"] == 42
    assert body["issue_reading"] == pytest.approx(1430)
    assert body["bound_issue_ms"] == pytest.approx(0.04482154882154882)
    assert ov["issue_reading"] == pytest.approx(0.1263 / 0.12506152433425 * 42)
    assert round(body["bound_ms"], 4) == 0.0063 and round(ov["bound_ms"], 4) == 0.0312
    assert body["bound_unfused_ms"] > body["bound_ms"] and ov["bound_unfused_ms"] > ov["bound_ms"]
    assert set(body_ab.three_bounds(sass, 1.98e9, {"probe_overlap": 0.1})) == {"probe_overlap"}


def test_body_ab_imports_no_jax():
    """The tool imports torch and the port, never JAX or the JAX package."""
    tree = ast.parse(Path(body_ab.__file__).read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module or "" for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
    assert names and not [n for n in names if n.split(".")[0] in ("jax", "zraytrace_tpu")]
