"""scripts/sass_counts.py's parser on a listing in ``cuobjdump -sass``'s
form: each opcode in its pipe's class, predicated and modified opcodes by
their base name, and a loop as the code from a backward branch's target up
to the branch."""

import importlib.util
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("sass_counts", ROOT / "scripts" / "sass_counts.py")
sc = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(sc)

LISTING = """
        code for sm_90a
                Function : _ZN12_GLOBAL__N_115qe_price_kernelILb1EEEvPKfPKiPdxijjx
        .headerflags    @"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                  /* 0x00000a00ff017b82 */
                                                                           /* 0x000fe40000000800 */
        /*0010*/                   S2R R0, SR_TID.X ;                      /* 0x0000000000007919 */
        /*0020*/                   IMAD.HI.U32 R2, R0, -0x2daee0ad, RZ ;   /* 0x0000000000007919 */
        /*0030*/                   LOP3.LUT R3, R2, R4, R5, 0x96, !PT ;    /* 0x0000000000007919 */
        /*0040*/                   FFMA R6, R7, R8, R9 ;                   /* 0x0000000000007919 */
        /*0050*/               @P0 MUFU.RCP R10, R6 ;                      /* 0x0000000000007919 */
        /*0060*/                   FSETP.GT.AND P1, PT, R6, 1.5, PT ;      /* 0x0000000000007919 */
        /*0070*/              @!P1 BRA 0x20 ;                              /* 0x0000000000007919 */
        /*0080*/                   DADD R12, R12, R14 ;                    /* 0x0000000000007919 */
        /*0090*/                   I2F.U32 R3, R3 ;                        /* 0x0000000000007919 */
        /*00a0*/                   BRA 0xc0 ;                              /* 0x0000000000007919 */
        /*00b0*/                   STG.E.64 desc[UR4][R2.64], R12 ;        /* 0x0000000000007919 */
        /*00c0*/                   EXIT ;                                  /* 0x0000000000007919 */
                Function : other_kernel
        /*0000*/                   MUFU.EX2 R1, R2 ;                       /* 0x0000000000007919 */
"""


def test_functions_split_the_listing():
    fns = sc.functions(LISTING)
    assert list(fns) == ["_ZN12_GLOBAL__N_115qe_price_kernelILb1EEEvPKfPKiPdxijjx",
                         "other_kernel"]
    assert [op for _, op, _, _ in fns["other_kernel"]] == ["MUFU"]


@pytest.mark.parametrize("op, cls", [("IMAD", "fma"), ("LOP3", "alu"), ("FFMA", "fma"),
                                     ("FSETP", "fp32"), ("MUFU", "mufu"), ("DADD", "fp64"),
                                     ("I2F", "convert"), ("STG", "mem"), ("BRA", "other")])
def test_each_opcode_takes_its_class(op, cls):
    assert sc.op_class(op) == cls


def test_counts_and_loops():
    instrs = next(iter(sc.functions(LISTING).values()))
    whole = sc.counts(instrs)
    assert (whole["alu"], whole["fma"], whole["fp32"], whole["mufu"], whole["fp64"],
            whole["convert"], whole["mem"], whole["other"], whole["total"]) == (
                1, 2, 1, 1, 1, 1, 2, 4, 13)
    assert whole["mufu_ops"] == {"MUFU.RCP": 1} and whole["imad"] == 1
    (loop,) = sc.loops(instrs)  # the forward BRA 0xc0 is no loop
    assert (loop["from"], loop["to"]) == ("0x20", "0x70")
    assert (loop["alu"], loop["fma"], loop["fp32"], loop["mufu"], loop["other"],
            loop["total"]) == (1, 2, 1, 1, 1, 6)


def test_listing_blocks_keep_each_function_whole():
    blocks = sc.listing_blocks(LISTING)
    assert list(blocks) == list(sc.functions(LISTING))
    assert blocks["other_kernel"].count("MUFU.EX2") == 1
    assert "DADD" in blocks["_ZN12_GLOBAL__N_115qe_price_kernelILb1EEEvPKfPKiPdxijjx"]


@pytest.mark.parametrize("name, counted", [
    ("_ZN12_GLOBAL__N_119heston_euler_kernelILb1EEEvPKfPfxijj", True),
    ("_ZN12_GLOBAL__N_119exact_values_kernelILb0EEEvPKfPKiPfxiijjx", True),
    ("_ZN12_GLOBAL__N_126exact_values_single_kernelILb1EEEvPKfPKiPfxiijjx", False),
    ("_ZN12_GLOBAL__N_118exact_price_kernelILb1EEEvPKfPKiPdxiijjx", False),
], ids=["K1", "K2", "K2 one group", "K3"])
def test_default_kernels_count_the_euler_and_exact_values_kernels(name, counted):
    """The default patterns take K1 and K2 (antithetic, every instantiation)
    beside the serving kernels, and no other exact kernel."""
    assert sc.wanted(name, sc.DEFAULT_KERNELS) is counted


@pytest.mark.parametrize("name, counted", [
    ("_ZN12_GLOBAL__N_116qe_values_kernelILb1ELi1EEEvPKfPKiPfxiijjx", True),
    ("_ZN12_GLOBAL__N_116qe_values_kernelILb0ELi1EEEvPKfPKiPfxiijjx", True),
    ("_ZN12_GLOBAL__N_116qe_values_kernelILb0ELi0EEEvPKfPKiPfxiijjx", True),
    ("_ZN12_GLOBAL__N_119qem_terminal_kernelILb1ELi1EEEvPKfPKiPfxiiijjx", True),
    ("_ZN12_GLOBAL__N_119qem_terminal_kernelILb0ELi1EEEvPKfPKiPfxiiijjx", True),
    ("_ZN12_GLOBAL__N_119qem_terminal_kernelILb0ELi0EEEvPKfPKiPfxiiijjx", True),
    ("_ZN12_GLOBAL__N_113qe_vjp_kernelILb1EEEvPKfS2_PKiS2_Pdxiijjx", True),
    ("_ZN12_GLOBAL__N_113qe_vjp_kernelILb1ELi1EEEvPKfS2_PKiS2_Pdxiijjx", True),
    ("_ZN12_GLOBAL__N_113qe_vjp_kernelILb0ELi1EEEvPKfS2_PKiS2_Pdxiijjx", True),
    ("_ZN12_GLOBAL__N_113qe_vjp_kernelILb0ELi0EEEvPKfS2_PKiS2_Pdxiijjx", True),
    ("_ZN12_GLOBAL__N_116rb_values_kernelILb1EEEvPKfPKiPfxiijjx", False),
], ids=["K7 staged QMC", "K7 global QMC", "K7 PRNG", "K5 staged QMC", "K5 global QMC", "K5 PRNG",
        "K11", "K11 staged QMC", "K11 global QMC", "K11 PRNG", "K14"])
def test_default_kernels_count_every_values_and_terminal_build(name, counted):
    """The default patterns take each stream's build of K7 (qe_values_kernel),
    K5 (qem_terminal_kernel) and K11 (qe_vjp_kernel, and its one build for
    both streams before its redesign), and not the rough-Bergomi values
    kernel."""
    assert sc.wanted(name, sc.DEFAULT_KERNELS) is counted
