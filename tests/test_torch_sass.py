"""The port's SASS reader (``tpuminter_torch.kernels.sass``) on a fixed
``cuobjdump -sass`` text: kernel names from mangled symbols, and each
instruction's issue pipe (every ``IMAD`` form on the FMA pipe; adds,
logic and shifts on the ALU), over the whole kernel and its hot loop.
No ``cuobjdump`` is needed."""

import pytest

from tpuminter_torch.kernels import sass

K5_SCHED = ("_ZN41_GLOBAL__N__fb8a9db1_9_sha256_cu_0c60d0e734"
            "search_candidates_hdr_batch_kernelILb1EEEvPKxS2_S2_S2_ijjPy")
K5_PLAIN = K5_SCHED.replace("ILb1EE", "ILb0EE")
FILL = ("_ZN41_GLOBAL__N__fb8a9db1_9_scrypt_cu_0c60d0e719"
        "scrypt_front_kernelE14TmScryptHeaderPKxPxP5uint4iii")

SASS = f"""
Fatbin elf code:
================
arch = sm_90a
code version = [1,7]

\tcode for sm_90a
\t\tFunction : {K5_SCHED}
\t.headerflags\t@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                           /* 0x00000a00ff017b82 */
        /*0010*/                   S2R R0, SR_CTAID.X ;                             /* 0x0000000000007919 */
        /*0020*/                   ULDC.64 UR4, c[0x0][0x208] ;                     /* 0x0000820000047ab9 */
        /*0030*/                   IMAD.MOV.U32 R2, RZ, RZ, c[0x0][0x220] ;         /* 0x00008800ff027624 */
        /*0040*/                   IADD3 R3, R2, 0x428a2f98, R0 ;                   /* 0x428a2f9802037810 */
        /*0050*/                   LOP3.LUT R4, R3, R2, R0, 0x96, !PT ;             /* 0x0000000203047212 */
        /*0060*/                   SHF.R.W.U32.HI R5, R4, 0x6, R4 ;                 /* 0x0000000604057819 */
        /*0070*/                   IMAD.IADD R6, R5, 0x1, R3 ;                      /* 0x0000000105067824 */
        /*0080*/                   IMAD R7, R6, c[0x0][0x230], R5 ;                 /* 0x00008c0006077a24 */
        /*0090*/                   IMAD.HI.U32 R8, R7, c[0x0][0x2a0], RZ ;          /* 0x0000a80007087a27 */
        /*00a0*/                   PRMT R9, R8, 0x123, RZ ;                         /* 0x0000012308097816 */
        /*00b0*/                   ISETP.GE.U32.AND P0, PT, R9, R2, PT ;            /* 0x000000020900720c */
        /*00c0*/               @!P0 BRA 0x40 ;                                      /* 0xffffff7000008947 */
        /*00d0*/                   SEL R10, R9, R2, P0 ;                            /* 0x0000000209107207 */
        /*00e0*/                   STG.E.64 desc[UR4][R2.64], R10 ;                 /* 0x0000000a02007986 */
        /*00f0*/                   EXIT ;                                           /* 0x000000000000794d */
        /*0100*/                   BRA 0x100;                                       /* 0xfffffff000007947 */
        ..........

\t\tFunction : {K5_PLAIN}
\t.headerflags\t@"EF_CUDA_SM90"
        /*0000*/                   IADD3 R1, R1, 0x1, RZ ;                          /* 0x0000000101017810 */
        /*0010*/                   EXIT ;                                           /* 0x000000000000794d */
        /*0020*/                   BRA 0x20;                                        /* 0xfffffff000007947 */
        ..........

\t\tFunction : {FILL}
\t.headerflags\t@"EF_CUDA_SM90"
        /*0000*/                   MOV R1, c[0x0][0x28] ;                           /* 0x00000a0000017a02 */
        /*0010*/                   SHFL.IDX PT, R2, R1, 0x1, 0x1c1f ;               /* 0x00000000ff027f89 */
        /*0020*/                   IMAD.SHL.U32 R3, R2, 0x4, RZ ;                   /* 0x0000000402037824 */
        /*0030*/                   STG.E.128 desc[UR4][R4.64], R8 ;                 /* 0x0000000804007986 */
        /*0040*/               @P1 BRA 0x10 ;                                       /* 0x0000000001007947 */
        /*0050*/                   EXIT ;                                           /* 0x000000000000794d */
"""


@pytest.mark.parametrize("opcode,pipe", [
    ("IMAD.IADD", "fma"), ("IMAD.MOV.U32", "fma"), ("IMAD.SHL.U32", "fma"), ("IMAD", "fma"),
    ("IMAD.HI.U32", "fma"), ("IMAD.WIDE.U32", "fma"),
    ("IADD3", "alu"), ("LOP3.LUT", "alu"), ("SHF.R.W.U32.HI", "alu"), ("SHF.L.U32", "alu"),
    ("PRMT", "alu"), ("ISETP.GE.U32.AND", "alu"), ("SEL", "alu"),
    ("SHFL.IDX", "other"), ("STG.E.128", "other"), ("BRA", "other"), ("ULDC.64", "other"),
    ("S2R", "other"), ("LDC", "other"),
])
def test_pipe_of(opcode, pipe):
    assert sass.pipe_of(opcode) == pipe


def test_kernel_names_from_mangled_symbols():
    assert sass.kernel_name(K5_SCHED) == "search_candidates_hdr_batch_kernel<sched>"
    assert sass.kernel_name(K5_PLAIN) == "search_candidates_hdr_batch_kernel"
    assert sass.kernel_name(FILL) == "scrypt_front_kernel"


def test_pipe_mix_counts_kernel_and_hot_loop():
    mix = sass.pipe_mix(SASS)
    assert list(mix) == ["search_candidates_hdr_batch_kernel<sched>",
                         "search_candidates_hdr_batch_kernel", "scrypt_front_kernel"]
    k5 = mix["search_candidates_hdr_batch_kernel<sched>"]
    # the 17 instructions: 6 ALU (IADD3, LOP3, SHF, PRMT, ISETP, SEL),
    # 4 FMA (IMAD.MOV, IMAD.IADD, IMAD, IMAD.HI), 7 other
    assert k5["total"] == {"alu": 6, "fma": 4, "other": 7}
    # the loop 0x40-0xc0; the branch to itself at 0x100 closes no loop
    assert k5["loop"] == {"alu": 5, "fma": 3, "other": 1}
    assert mix["search_candidates_hdr_batch_kernel"] == {
        "total": {"alu": 1, "fma": 0, "other": 2}, "loop": None}
    assert mix["scrypt_front_kernel"]["loop"] == {"alu": 0, "fma": 1, "other": 3}


def test_parse_sass_reads_guards_and_branch_targets():
    insts = sass.parse_sass(SASS)["search_candidates_hdr_batch_kernel<sched>"]
    assert insts[12] == (0xC0, "BRA", 0x40)  # the guard (@!P0) is dropped
    assert insts[4] == (0x40, "IADD3", None)
    assert len(insts) == 17


def test_cli_prints_each_kernels_mix(monkeypatch, capsys):
    monkeypatch.setattr(sass, "sass_text", lambda path: SASS)
    assert sass.main(["build/tm_sha256_x.so"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 3
    assert lines[0].startswith("tm_sha256_x.so search_candidates_hdr_batch_kernel<sched>: total "
                               "{'alu': 6, 'fma': 4, 'other': 7}, loop {'alu': 5,")
