"""``chip_smoke.py`` on a machine without a GPU: it exits non-zero and
prints no result line, also when it lies alone in a directory.  And its
host-side helpers: the ptxas and SASS parsers on both kernel name forms,
and the per-candidate operation counts behind ``bound_ms``."""

import importlib.util
import os
import shutil
import subprocess
import sys

import pytest
import torch

from distpow_tpu_torch.models.registry import get_hash_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "chip_smoke.py")


def _load():
    spec = importlib.util.spec_from_file_location("chip_smoke", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def no_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: these tests describe a machine without one")


@pytest.mark.parametrize("alone", [False, True])
def test_exits_nonzero_without_a_gpu(no_gpu, tmp_path, alone):
    script = SCRIPT
    if alone:
        script = str(tmp_path / "chip_smoke.py")
        shutil.copy(SCRIPT, script)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, script], cwd=os.path.dirname(script), env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


PTXAS = """
ptxas info    : Compiling entry function '_ZN7distpow17md5_search_kernelILi2ELi1ELb1EEEvPKjS2_S2_NS_6LayoutEjPj' for 'sm_90a'
ptxas info    : Function properties for _ZN7distpow17md5_search_kernelILi2ELi1ELb1EEEvPKjS2_S2_NS_6LayoutEjPj
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 54 registers, used 1 barriers, 32 bytes smem
ptxas info    : Compiling entry function '_ZN7distpow18hash_search_kernelINS_9Ripemd160ELi4ELi2ELb0EEEvPKjS3_S3_NS_6LayoutEjPj' for 'sm_90a'
ptxas info    : Function properties for _ZN7distpow18hash_search_kernelINS_9Ripemd160ELi4ELi2ELb0EEEvPKjS3_S3_NS_6LayoutEjPj
    24 bytes stack frame, 20 bytes spill stores, 20 bytes spill loads
ptxas info    : Used 80 registers, used 1 barriers, 24 bytes cumulative stack size, 32 bytes smem
ptxas info    : Compiling entry function '_ZN7distpow18hash_search_kernelINS_6Sha512ELi16ELi2ELb1EEEvPKjS3_S3_NS_6LayoutEjPj' for 'sm_90a'
ptxas info    : Function properties for _ZN7distpow18hash_search_kernelINS_6Sha512ELi16ELi2ELb1EEEvPKjS3_S3_NS_6LayoutEjPj
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 224 bytes smem
"""

SASS = """
        Function : _ZN7distpow18hash_search_kernelINS_7Sha256dELi8ELi1ELb1EEEvPKjS3_S3_NS_6LayoutEjPj
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   S2R R0, SR_TID.X ;
.L_x_1:
        /*0020*/                   IADD3 R2, R2, 0x1, RZ ;
        /*0030*/                   NOP ;
        /*0040*/                   LOP3.LUT R3, R2, R4, R5, 0x96, !PT ;
        /*0050*/               @P0 BRA `(.L_x_1) ;
        /*0060*/                   EXIT ;
"""


def test_parsers_read_both_kernel_name_forms():
    cs = _load()
    assert cs.parse_ptxas(PTXAS) == {
        (2, 1, True): {"registers": 54, "spill_bytes": 0},
        (4, 2, False): {"registers": 80, "spill_bytes": 40},
        (16, 2, True): {"registers": 168, "spill_bytes": 0},
    }
    # the loop body between the backward branch and its target, NOPs excluded
    assert cs.spec_sass_loops(SASS) == {(8, 1, True): {"IADD3": 1, "LOP3.LUT": 1, "BRA": 1}}


def test_needed_ops_of_the_timed_launches():
    """The counts behind each model's bound in PERF.md: difficulty 16 (two
    mask words), one tail block, the variable bytes in words 1 and 2."""
    cs = _load()
    got = {m: cs.needed_ops(m, 1, 2, {1, 2}) for m in cs.MODELS}
    assert got == {"md5": 215, "sha256": 1221, "sha256d": 2545, "sha1": 548,
                   "ripemd160": 643, "sha512": 3163, "sha384": 3259, "sha3_256": 4145,
                   "blake2b_256": 2014}
    for m in cs.MODELS:
        # more live digest words, a second block or more varying words cost
        # more, never less
        counts = [cs.needed_ops(m, 1, mw, {1, 2}) for mw in range(1, 5)]
        assert counts == sorted(counts)
        wpb = get_hash_model(m).words_per_block
        assert cs.needed_ops(m, 2, 2, {wpb - 1, wpb}) > got[m]
        assert cs.needed_ops(m, 1, 2, set(range(wpb))) > got[m]


PROBE_SASS = """
        Function : _Z12probe_kernelILi1ELi4EEvjjPj
        /*0000*/                   S2R R0, SR_TID.X ;
.L_x_0:
        /*0010*/                   SHF.L.W.U32.HI R2, R2, 0x7, R3 ;
        /*0020*/                   IMAD.HI.U32 R3, R3, c[0x0][0x214], R4 ;
        /*0030*/                   VIADD R5, R5, 0x1 ;
        /*0040*/                   ISETP.GE.U32.AND P0, PT, R5, c[0x0][0x210], PT ;
        /*0050*/              @!P0 BRA `(.L_x_0) ;
        /*0060*/                   EXIT ;
"""


def test_sass_loops_keep_modifiers_and_split_by_pipe():
    """``sass_loops`` keeps each opcode's modifiers (what the pipe probe
    checks), and ``pipe_split`` counts a loop by the pipe each opcode
    issues to, with or without modifiers."""
    cs = _load()
    assert cs.sass_loops(SASS) == {
        "_ZN7distpow18hash_search_kernelINS_7Sha256dELi8ELi1ELb1EEEvPKjS3_S3_NS_6LayoutEjPj":
            {"IADD3": 1, "LOP3.LUT": 1, "BRA": 1}}
    loops = cs.sass_loops(PROBE_SASS)
    assert loops == {"_Z12probe_kernelILi1ELi4EEvjjPj": {
        "SHF.L.W.U32.HI": 1, "IMAD.HI.U32": 1, "VIADD": 1, "ISETP.GE.U32.AND": 1, "BRA": 1}}
    assert cs.pipe_split({"IMAD": 3, "VIADD": 1, "LOP3": 5, "SHF": 2, "ISETP": 1, "BRA": 1,
                          "LDS": 2}) == {"alu": 8, "fma": 4, "fma_slots": 4, "other": 3}


ROUTED_SASS = """
        Function : _ZN7distpow27resident_hash_search_kernelINS_11Blake2b_256ELi2ELi1ELb1EEEvPKjS3_S3_NS_6LayoutEjPj
        /*0000*/                   S2R R0, SR_TID.X ;
.L_x_3:
        /*0010*/                   IMAD.WIDE.U32 R4, R2, c[0x3][0x0], R4 ;
        /*0020*/                   IMAD R5, R3, c[0x3][0x0], R5 ;
        /*0030*/                   IADD3 R6, P0, R6, R8, RZ ;
        /*0040*/                   IMAD.X R7, R7, c[0x3][0x0], R9, P0 ;
        /*0050*/                   IMAD.HI.U32 R10, R10, c[0x3][0x68], RZ ;
        /*0060*/                   IMAD.WIDE.U32 R14, R2, c[0x3][0x0], R14 ;
        /*0070*/                   LOP3.LUT R11, R4, R6, RZ, 0x3c, !PT ;
        /*0080*/                   SHF.R.W.U32 R12, R11, 0x18, R5 ;
        /*0090*/                   LDS R13, [UR4+0x10] ;
        /*00a0*/                   VIADD R0, R0, 0x1 ;
        /*00b0*/               @P1 BRA `(.L_x_3) ;
        /*00c0*/                   EXIT ;
"""


def test_fma_pipe_slots_weigh_half_rate_opcodes():
    """``pipe_split`` reads the IMAD forms from a loop with modifiers:
    IMAD.HI and IMAD.WIDE take two FMA-pipe slots, IMAD, IMAD.X and VIADD
    one.  ``pipe_ms``
    then shows the pipe that sets the pace: here the FMA pipe's 9 slots a
    hash against 3 ALU-pipe instructions."""
    cs = _load()
    loops = cs.spec_sass_loops(ROUTED_SASS)
    loop = loops[(2, 1, True)]
    assert loop["IMAD.WIDE.U32"] == 2 and loop["IMAD.X"] == 1 and loop["IMAD.HI.U32"] == 1
    pipes = cs.pipe_split(loop)
    assert pipes == {"alu": 3, "fma": 6, "fma_slots": 9, "other": 2}
    # 64 thread results a clock per SM on each pipe: one clock a second on
    # one SM hashes 64 candidates of the loop in 3 / 64 s and 9 / 64 s
    ms = cs.pipe_ms(pipes, 64, 1.0)
    assert ms == {"alu_pipe_ms": 3000.0, "fma_pipe_ms": 9000.0}


SWITCH_SASS = """
        Function : _ZN7distpow18hash_search_kernelINS_6Sha512ELi2ELi1ELb1EEEvPKjS3_S3_NS_6LayoutEjPj
        /*0000*/                   S2R R0, SR_TID.X ;
.L_x_5:
        /*0010*/                   LDS R4, [R20+0x4] ;
        /*0020*/                   ISETP.GT.AND P1, PT, R62, 0x2, PT ;
        /*0030*/               @P1 BRA `(.L_x_6) ;
        /*0040*/                   VIMNMX.U32 R61, R62, 0x2, PT ;
        /*0050*/                   LDC R62, c[0x2][R61+0xc] ;
        /*0060*/                   BRX R62 -0x70 ;
        /*0070*/                   LOP3.LUT R31, R31, R60, RZ, 0xfc, !PT ;
        /*0080*/                   LOP3.LUT R30, R30, R59, RZ, 0xfc, !PT ;
        /*0090*/                   BRA `(.L_x_7) ;
        /*00a0*/                   LOP3.LUT R30, R30, R60, RZ, 0xfc, !PT ;
        /*00b0*/                   BRA `(.L_x_7) ;
.L_x_6:
        /*00c0*/                   LOP3.LUT R29, R29, R60, RZ, 0xfc, !PT ;
        /*00d0*/                   BRA `(.L_x_7) ;
.L_x_7:
        /*00e0*/                   SHF.L.W.U32.HI R2, R31, 0x8, R30 ;
        /*00f0*/                   IADD3 R3, P0, R2, R29, RZ ;
        /*0100*/                   IMAD.X R4, R4, 0x1, R5, P0 ;
        /*0110*/               @P2 BRA `(.L_x_5) ;
        /*0120*/                   EXIT ;
"""


def test_issued_path_counts_one_switch_case():
    """A switch in the loop (a compare tree, a jump table, cases that jump
    to one merge point) is counted whole in the loop body, but one candidate
    issues one case: ``path`` follows the fall-through path, unconditional
    forward branches and the jump table's first case.  A loop without such
    jumps issues its whole body."""
    cs = _load()
    whole = cs.spec_sass_loops(SWITCH_SASS)[(2, 1, True)]
    issued = cs.spec_sass_loops(SWITCH_SASS, path=True)[(2, 1, True)]
    assert sum(whole.values()) == 17
    # the tree's untaken branch, case 0's jump to the merge, the loop's branch
    assert issued == {"LDS": 1, "ISETP.GT.AND": 1, "BRA": 3, "VIMNMX.U32": 1, "LDC": 1,
                      "BRX": 1, "LOP3.LUT": 2, "SHF.L.W.U32.HI": 1, "IADD3": 1, "IMAD.X": 1}
    assert cs.pipe_split(issued) == {"alu": 5, "fma": 1, "fma_slots": 1, "other": 7}
    for listing in (SASS, PROBE_SASS, ROUTED_SASS):
        assert cs.sass_loops(listing, path=True) == cs.sass_loops(listing)


def test_pipe_probe_names_what_ptxas_issued():
    """The pipe probe names a probe from its kernel's template keys and
    counts the loop in the probes' own opcode kinds."""
    from distpow_tpu_torch.tools import pipe_rates

    cs = _load()
    assert cs.opcode_kind("IMAD.HI.U32") == "IMAD.HI"
    assert cs.opcode_kind("IMAD.WIDE.U32") == "IMAD.WIDE"
    assert cs.opcode_kind("IMAD.U32") == "IMAD"
    assert cs.opcode_kind("SHF.L.W.U32.HI") == "SHF"
    loops = pipe_rates.probe_loops(PROBE_SASS, cs)
    assert loops == {pipe_rates.PROBES.index("SHF+IMAD.HI"): {
        "SHF": 1, "IMAD.HI": 1, "VIADD": 1, "ISETP": 1, "BRA": 1}}


@pytest.mark.parametrize("kernel,label,kinds", [
    ("_Z14probe64_kernelILi1ELi8ELi1EEvjjPj", "ADD64.CARRY", {"IADD3", "IMAD.X"}),
    ("_Z14probe64_kernelILi5ELi8ELi5EEvjjPj", "ADD3_64.WIDE", {"IMAD.WIDE", "IMAD"}),
    ("_Z14probe64_kernelILi6ELi4ELi2EEvjjPj", "XROT64x4+ADD64.WIDEx4",
     {"LOP3", "SHF", "IMAD.WIDE", "IMAD"}),
    ("_Z12probe_kernelILi7ELi3EEvjjPj", "PRMT+IMAD", {"PRMT", "IMAD"}),
])
def test_pipe_probe_names_64_bit_and_prmt_probes(kernel, label, kinds):
    """The 64-bit chain probes and the byte-permute probes are named from
    their kernels' template keys, and each names the opcodes it should
    issue and how many of its operations a loop iteration holds."""
    from distpow_tpu_torch.tools import pipe_rates

    assert pipe_rates.probe_label(kernel) == label
    assert label in pipe_rates.PROBES
    named, per_iteration = pipe_rates.named_kinds(label)
    assert named == kinds
    assert sum(per_iteration.values()) == pipe_rates.CHAINS * pipe_rates.STEPS


GROUP_PTXAS = """
ptxas info    : Compiling entry function '_ZN7distpow23md5_group_search_kernelILi2EEEvPKjS2_S2_S2_S2_S2_iijjPj' for 'sm_90a'
ptxas info    : Function properties for _ZN7distpow23md5_group_search_kernelILi2EEEvPKjS2_S2_S2_S2_S2_iijjPj
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 60 registers, used 1 barriers, 32 bytes smem
ptxas info    : Compiling entry function '_ZN7distpow33resident_hash_group_search_kernelINS_7Sha256dELi2EEEvPKjS3_S3_S3_S3_S3_iijjPj' for 'sm_90a'
ptxas info    : Function properties for _ZN7distpow33resident_hash_group_search_kernelINS_7Sha256dELi2EEEvPKjS3_S3_S3_S3_S3_iijjPj
    24 bytes stack frame, 12 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 48 registers, used 1 barriers, 24 bytes cumulative stack size, 32 bytes smem
"""


def test_group_kernel_parsers_keep_apart_from_the_solo_ones():
    """The group kernels' names carry only the tail length: their own
    parsers read them, and the solo parsers skip them."""
    cs = _load()
    assert cs.parse_group_ptxas(GROUP_PTXAS) == {
        2: {"registers": 48, "spill_bytes": 24}}
    assert cs.parse_group_ptxas(GROUP_PTXAS.split("ptxas info    : Compiling entry function "
                                                  "'_ZN7distpow33")[0]) == {
        2: {"registers": 60, "spill_bytes": 0}}
    assert cs.parse_ptxas(GROUP_PTXAS) == {}
    sass = SASS.replace("18hash_search_kernelINS_7Sha256dELi8ELi1ELb1EEEv",
                        "24hash_group_search_kernelINS_6Sha256ELi1EEEv")
    assert cs.group_sass_loops(sass) == {1: {"IADD3": 1, "LOP3.LUT": 1, "BRA": 1}}
    assert cs.spec_sass_loops(sass) == {}


MESH_PTXAS = """
ptxas info    : Compiling entry function '_ZN7distpow15md5_mesh_kernelILi2ELi1ELb1EEEvPKjS2_S2_NS_6LayoutENS_10MeshOriginEjPj' for 'sm_90a'
ptxas info    : Function properties for _ZN7distpow15md5_mesh_kernelILi2ELi1ELb1EEEvPKjS2_S2_NS_6LayoutENS_10MeshOriginEjPj
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 56 registers, used 1 barriers, 32 bytes smem
ptxas info    : Compiling entry function '_ZN7distpow25resident_hash_mesh_kernelINS_8Sha3_256ELi4ELi2ELb0EEEvPKjS3_S3_NS_6LayoutENS_10MeshOriginEjPj' for 'sm_90a'
ptxas info    : Function properties for _ZN7distpow25resident_hash_mesh_kernelINS_8Sha3_256ELi4ELi2ELb0EEEvPKjS3_S3_NS_6LayoutENS_10MeshOriginEjPj
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 102 registers, used 1 barriers, 8 bytes cumulative stack size, 32 bytes smem
"""


def test_mesh_kernel_parsers_keep_apart_from_the_solo_ones():
    """The mesh kernels carry the solo kernels' keys under their own names:
    MESH_KEY reads them (the resident form too), and the solo parsers, which
    judge the solo kernels against the parent build, skip them."""
    cs = _load()
    assert cs.parse_ptxas(MESH_PTXAS, cs.MESH_KEY) == {
        (2, 1, True): {"registers": 56, "spill_bytes": 0},
        (4, 2, False): {"registers": 102, "spill_bytes": 8}}
    assert cs.parse_ptxas(MESH_PTXAS) == {}
    assert cs.parse_ptxas(PTXAS + MESH_PTXAS) == cs.parse_ptxas(PTXAS)
    assert cs.parse_ptxas(PTXAS, cs.MESH_KEY) == {}
    sass = SASS.replace("18hash_search_kernelINS_7Sha256dELi8ELi1ELb1EEEv",
                        "16hash_mesh_kernelINS_7Sha256dELi8ELi1ELb1EEEv")
    assert cs.spec_sass_loops(sass, key=cs.MESH_KEY) == {
        (8, 1, True): {"IADD3": 1, "LOP3.LUT": 1, "BRA": 1}}
    assert cs.spec_sass_loops(sass) == {} and cs.group_sass_loops(sass) == {}
    # the kernels line names the mesh kernels' TPU counterpart
    assert cs.REPLACES_MESH.startswith("distpow_tpu/parallel/mesh_search.py:178 ")


KEYED_PTXAS = """
ptxas info    : Compiling entry function '_ZN7distpow18hash_search_kernelINS_3Md5ILi1EEELi2ELi1ELb1EEEvPKjS4_S4_NS_6LayoutEjPj' for 'sm_90a'
ptxas info    : Function properties for _ZN7distpow18hash_search_kernelINS_3Md5ILi1EEELi2ELi1ELb1EEEvPKjS4_S4_NS_6LayoutEjPj
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 72 registers, used 1 barriers, 112 bytes smem
ptxas info    : Compiling entry function '_ZN7distpow16hash_mesh_kernelINS_3Md5ILi14EEELi4ELi2ELb0EEEvPKjS4_S4_NS_6LayoutENS_10MeshOriginEjPj' for 'sm_90a'
ptxas info    : Function properties for _ZN7distpow16hash_mesh_kernelINS_3Md5ILi14EEELi4ELi2ELb0EEEvPKjS4_S4_NS_6LayoutENS_10MeshOriginEjPj
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 96 registers, used 1 barriers, 176 bytes smem
ptxas info    : Compiling entry function '_ZN7distpow24hash_group_search_kernelINS_3Md5ILi13EEELi1EEEvPKjS4_S4_S4_S4_S4_iijjPj' for 'sm_90a'
ptxas info    : Function properties for _ZN7distpow24hash_group_search_kernelINS_3Md5ILi13EEELi1EEEvPKjS4_S4_S4_S4_S4_iijjPj
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 70 registers, used 1 barriers, 112 bytes smem
"""


def test_parsers_read_md5_var_word_keys():
    """md5's kernels are built per tail layout: each key ends in the run's
    first message word, the variants' Md5Keyed<VW, ...> too, and the other
    hashes' keys keep their form."""
    cs = _load()
    assert cs.parse_ptxas(KEYED_PTXAS) == {(2, 1, True, 1): {"registers": 72, "spill_bytes": 0}}
    assert cs.parse_ptxas(KEYED_PTXAS, cs.MESH_KEY) == {
        (4, 2, False, 14): {"registers": 96, "spill_bytes": 0}}
    assert cs.parse_group_ptxas(KEYED_PTXAS) == {(1, 13): {"registers": 70, "spill_bytes": 0}}
    assert cs.spec_label((2, 1, True, 1)) == "mw2_nb1_pow2_vw1"
    assert cs.spec_label((16, 2, False)) == "mw16_nb2_div"
    variant = ("_ZN7distpow18hash_search_kernelINS_8Md5KeyedILi1ELb0EEELi2ELi1ELb1EEEvPKjS4_S4_"
               "NS_6LayoutEjPj")
    assert cs.name_key(variant, cs.KERNEL_KEY) == (2, 1, True, 1)
    assert cs.timed_key("md5") == (2, 1, True, 1) and cs.timed_key("sha1") == (2, 1, True)
    assert cs.group_key("md5", 2, 14) == (2, 14) and cs.group_key("sha256", 2, 14) == 2
    sass = SASS.replace("18hash_search_kernelINS_7Sha256dELi8ELi1ELb1EEEv",
                        "18hash_search_kernelINS_3Md5ILi7EEELi4ELi1ELb1EEEv")
    assert cs.spec_sass_loops(sass) == {(4, 1, True, 7): {"IADD3": 1, "LOP3.LUT": 1, "BRA": 1}}


def test_compare_builds_times_the_main_path_key_on_either_side():
    """A model whose set of specializations changed (md5, keyed by var_word
    on one side only) is compared at the timed launch on both sides."""
    from distpow_tpu_torch.tools.compare_builds import timed_row

    cs = _load()
    body = {"IADD3": 3, "IMAD": 2, "BRA": 1}
    old = {"ptxas": {(2, 1, True): {"registers": 60, "spill_bytes": 0}},
           "loops": {(2, 1, True): body}, "issued": {(2, 1, True): body}}
    new = {"ptxas": {(2, 1, True, 1): {"registers": 70, "spill_bytes": 0}},
           "loops": {(2, 1, True, 1): body, (2, 1, True, 5): {"IADD3": 9}},
           "issued": {(2, 1, True, 1): body, (2, 1, True, 5): {"IADD3": 9}}}
    assert timed_row(old, cs) == {"key": "mw2_nb1_pow2", "registers": 60, "spill_bytes": 0,
                                  "loop": 6, "issued": 6, "alu": 3, "fma": 2, "fma_slots": 2,
                                  "other": 1}
    assert timed_row(new, cs)["key"] == "mw2_nb1_pow2_vw1"
    assert timed_row(new, cs)["registers"] == 70


PERSISTENT_PTXAS = """
ptxas info    : Compiling entry function '_ZN7distpow22hash_persistent_kernelINS_3Md5ILi1EEELi2ELi1ELb1EEEvPKjS4_S4_NS_6LayoutEjPjNS_7PersistE' for 'sm_90a'
ptxas info    : Function properties for _ZN7distpow22hash_persistent_kernelINS_3Md5ILi1EEELi2ELi1ELb1EEEvPKjS4_S4_NS_6LayoutEjPjNS_7PersistE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 80 registers, used 1 barriers, 112 bytes smem
ptxas info    : Compiling entry function '_ZN7distpow31resident_hash_persistent_kernelINS_7Sha256dELi8ELi1ELb0EEEvPKjS3_S3_NS_6LayoutEjPjNS_7PersistE' for 'sm_90a'
ptxas info    : Function properties for _ZN7distpow31resident_hash_persistent_kernelINS_7Sha256dELi8ELi1ELb0EEEvPKjS3_S3_NS_6LayoutEjPjNS_7PersistE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 48 registers, used 1 barriers, 96 bytes smem
ptxas info    : Compiling entry function '_ZN7distpow27hash_mesh_persistent_kernelINS_6Sha512ELi2ELi2ELb1EEEvPKjS3_S3_NS_6LayoutENS_10MeshOriginEjPjNS_7PersistE' for 'sm_90a'
ptxas info    : Function properties for _ZN7distpow27hash_mesh_persistent_kernelINS_6Sha512ELi2ELi2ELb1EEEvPKjS3_S3_NS_6LayoutENS_10MeshOriginEjPjNS_7PersistE
    8 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 74 registers, used 1 barriers, 272 bytes smem
"""


def test_persistent_kernel_parsers_keep_apart_from_the_serial_ones():
    """The persistent forms of the solo and mesh kernels carry the same keys
    under their own names: PERSISTENT_KEY and MESH_PERSISTENT_KEY read them
    (md5's var_word and the resident form too), and the serial parsers,
    which count the serial kernels, skip them."""
    cs = _load()
    assert cs.parse_ptxas(PERSISTENT_PTXAS, cs.PERSISTENT_KEY) == {
        (2, 1, True, 1): {"registers": 80, "spill_bytes": 0},
        (8, 1, False): {"registers": 48, "spill_bytes": 0}}
    assert cs.parse_ptxas(PERSISTENT_PTXAS, cs.MESH_PERSISTENT_KEY) == {
        (2, 2, True): {"registers": 74, "spill_bytes": 16}}
    for key in (cs.KERNEL_KEY, cs.MESH_KEY):
        assert cs.parse_ptxas(PERSISTENT_PTXAS, key) == {}
    for key in (cs.PERSISTENT_KEY, cs.MESH_PERSISTENT_KEY):
        assert cs.parse_ptxas(PTXAS + MESH_PTXAS, key) == {}
    sass = SASS.replace("18hash_search_kernelINS_7Sha256dELi8ELi1ELb1EEEv",
                        "22hash_persistent_kernelINS_7Sha256dELi8ELi1ELb1EEEv")
    assert cs.spec_sass_loops(sass, key=cs.PERSISTENT_KEY) == {
        (8, 1, True): {"IADD3": 1, "LOP3.LUT": 1, "BRA": 1}}
    assert cs.spec_sass_loops(sass) == {} and cs.spec_sass_loops(sass, key=cs.MESH_KEY) == {}


def _phase_registrations():
    """``(name, needs)`` of each ``smoke.phase(...)`` call of ``main`` in
    source order; an f-string name reads as None."""
    import ast

    with open(SCRIPT) as fh:
        tree = ast.parse(fh.read())
    calls = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) and \
                node.func.attr == "phase" and isinstance(node.func.value, ast.Name) and \
                node.func.value.id == "smoke":
            name = node.args[0].value if isinstance(node.args[0], ast.Constant) else None
            needs = next((kw.value for kw in node.keywords if kw.arg == "needs"), None)
            needs = tuple(e.value for e in needs.elts) if isinstance(needs, ast.Tuple) and \
                all(isinstance(e, ast.Constant) for e in needs.elts) else needs
            calls.append((node.lineno, name, needs))
    return [(name, needs) for _, name, needs in sorted(calls, key=lambda c: c[0])]


def test_native_and_demo_are_registered_between_worker_cli_and_mesh_procs():
    phases = _phase_registrations()
    names = [name for name, _ in phases]
    assert dict(phases)["native"] == ("mine",)
    assert dict(phases)["demo"] == ("build", "mine")
    assert names.index("worker_cli") < names.index("native") < names.index("demo") < \
        names.index("mesh_procs")
    # every phase the script had keeps its place
    for earlier in ("device", "build", "sched_md5", "sched_cancel", "mine_mesh", "rate_mesh",
                    "sched_mesh", "worker_mine", "worker_fanout", "worker_mesh", "worker_sched",
                    "worker_cli", "mesh_procs"):
        assert earlier in names


def test_the_last_line_is_the_contract_ok_line():
    """``main`` ends in ``emit({"ok": True, "device": {"platform": "gpu",
    "kind": torch.cuda.get_device_name(0), "count":
    torch.cuda.device_count()}})`` and ``return 0``."""
    import ast

    with open(SCRIPT) as fh:
        tree = ast.parse(fh.read())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    *_, last_emit, ret = main.body
    assert isinstance(ret, ast.Return) and ret.value.value == 0
    call = last_emit.value
    assert isinstance(call, ast.Call) and call.func.id == "emit"
    (d,) = call.args
    top = dict(zip((k.value for k in d.keys), d.values))
    assert list(top) == ["ok", "device"] and top["ok"].value is True
    dev = dict(zip((k.value for k in top["device"].keys), top["device"].values))
    assert list(dev) == ["platform", "kind", "count"] and dev["platform"].value == "gpu"
    assert ast.unparse(dev["kind"]) == "torch.cuda.get_device_name(0)"
    assert ast.unparse(dev["count"]) == "torch.cuda.device_count()"


def test_demo_worker_shim_runs_the_worker_cli():
    """The demo's workers: the worker CLI's ``main`` with the CUDA backend's
    two kernel wrappers timed, then each launch's device ms written out."""
    import ast

    cs = _load()
    tree = ast.parse(cs.DEMO_WORKER_SHIM)
    text = ast.unparse(tree)
    assert "worker.main(sys.argv[2:])" in text
    assert "from distpow_tpu_torch.cli import worker" in text
    assert "('hash_search', 'hash_persistent_search')" in text
    assert not any(isinstance(n, (ast.Import, ast.ImportFrom)) and
                   any(a.name.split(".")[0] in ("jax", "distpow_tpu") for a in n.names)
                   for n in ast.walk(tree))


def test_demo_client_shim_runs_the_client_cli_and_waits_for_its_stdin():
    """The demo's client: the client CLI's ``main`` (here its ``--help``), then
    the done line, then the process stays up until its standard input closes
    (here at once)."""
    cs = _load()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", cs.DEMO_CLIENT_SHIM, "--help"], cwd=REPO, env=env,
                         input="", capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0].startswith("usage:") and "--config2" in out.stdout
    assert lines[-1] == cs.DEMO_CLIENT_DONE


# A claim loop (a barrier a tile) around a candidate loop, as the group and
# persistent kernels compile: the widest loop is the claim loop, the widest
# loop without a barrier the candidate loop
CLAIM_SASS = """
        Function : _ZN7distpow24hash_group_search_kernelINS_6Sha256ELi1EEEvPKj
.L_x_1:
        /*0000*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*0010*/                   LDS R2, [UR4] ;
.L_x_2:
        /*0020*/                   IADD3 R4, R4, 0x1, RZ ;
        /*0030*/                   LOP3.LUT R5, R4, R2, RZ, 0xfc, !PT ;
        /*0040*/                   IMAD R6, R5, 0x3, R4 ;
        /*0050*/               @P0 BRA `(.L_x_2) ;
        /*0060*/                   ATOMG.E.ADD.STRONG.GPU PT, R7, [R8.64], R9 ;
        /*0070*/               @P1 BRA `(.L_x_1) ;
        /*0080*/                   EXIT ;
"""


def test_candidate_loop_is_the_widest_without_a_barrier():
    """``sass_loops``' ``candidate`` skips a loop whose body holds a
    barrier: the group kernels' loop is their candidate loop, not the claim
    loop around it; a listing without barriers gives the same loops."""
    cs = _load()
    name = "_ZN7distpow24hash_group_search_kernelINS_6Sha256ELi1EEEvPKj"
    assert sum(cs.sass_loops(CLAIM_SASS)[name].values()) == 8
    assert cs.sass_loops(CLAIM_SASS, candidate=True)[name] == {
        "IADD3": 1, "LOP3.LUT": 1, "IMAD": 1, "BRA": 1}
    assert cs.group_sass_loops(CLAIM_SASS) == {1: {"IADD3": 1, "LOP3.LUT": 1, "IMAD": 1,
                                                   "BRA": 1}}
    for listing in (SASS, PROBE_SASS, ROUTED_SASS, SWITCH_SASS):
        assert cs.sass_loops(listing, candidate=True) == cs.sass_loops(listing)


@pytest.mark.parametrize("registers,blocks", [(24, 8), (32, 8), (40, 6), (58, 4), (64, 4),
                                              (77, 3), (80, 3), (93, 2), (128, 2), (255, 1)])
def test_blocks_per_sm_from_registers(registers, blocks):
    """Resident 256-thread blocks an SM holds at a kernel's registers: the
    registers a thread rounded up to 8, 65,536 an SM, at most 8 blocks."""
    assert _load().blocks_per_sm(registers) == blocks
