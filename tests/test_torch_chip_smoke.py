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
    assert cs.parse_sass_loops(SASS) == {(8, 1, True): {"IADD3": 1, "LOP3": 1, "BRA": 1}}


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
    checks), ``parse_sass_loops`` drops them, and ``pipe_split`` counts a
    loop by the pipe each opcode issues to."""
    cs = _load()
    assert cs.sass_loops(SASS) == {
        "_ZN7distpow18hash_search_kernelINS_7Sha256dELi8ELi1ELb1EEEvPKjS3_S3_NS_6LayoutEjPj":
            {"IADD3": 1, "LOP3.LUT": 1, "BRA": 1}}
    loops = cs.sass_loops(PROBE_SASS)
    assert loops == {"_Z12probe_kernelILi1ELi4EEvjjPj": {
        "SHF.L.W.U32.HI": 1, "IMAD.HI.U32": 1, "VIADD": 1, "ISETP.GE.U32.AND": 1, "BRA": 1}}
    assert cs.pipe_split({"IMAD": 3, "VIADD": 1, "LOP3": 5, "SHF": 2, "ISETP": 1, "BRA": 1,
                          "LDS": 2}) == {"alu": 8, "fma": 4, "other": 3}


def test_pipe_probe_names_what_ptxas_issued():
    """The pipe probe names a probe from its kernel's template keys and
    counts the loop in the probes' own opcode kinds."""
    from distpow_tpu_torch.tools import pipe_rates

    assert pipe_rates.opcode_kind("IMAD.HI.U32") == "IMAD.HI"
    assert pipe_rates.opcode_kind("IMAD.WIDE.U32") == "IMAD.WIDE"
    assert pipe_rates.opcode_kind("IMAD.U32") == "IMAD"
    assert pipe_rates.opcode_kind("SHF.L.W.U32.HI") == "SHF"
    loops = pipe_rates.probe_loops(PROBE_SASS, _load().sass_loops)
    assert loops == {pipe_rates.PROBES.index("SHF+IMAD.HI"): {
        "SHF": 1, "IMAD.HI": 1, "VIADD": 1, "ISETP": 1, "BRA": 1}}
