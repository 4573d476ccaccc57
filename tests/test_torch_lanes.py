"""The port's lane planner (``distpow_tpu_torch/sched/lanes.py``) with
injected capabilities, so the matrix runs without a card: on a CUDA device
the ``cuda`` lane (the group kernel) takes every group, width-0 and
two-block tails included; on the CPU the ``torch`` lane; the reference's
lane names map onto the port's; ``mesh`` and unknown names raise; the cuda
lane's builder refuses what the kernel cannot take, and nothing demotes."""

import pytest

from distpow_tpu_torch.models.registry import get_hash_model
from distpow_tpu_torch.ops.packing import build_tail_spec
from distpow_tpu_torch.sched.lanes import (LaneCaps, LanePlanner, build_cuda_group_step,
                                           lane_name)

MODELS = ("md5", "sha256", "sha256d", "sha1", "ripemd160", "sha512", "sha384", "sha3_256",
          "blake2b_256")


def _gdef(name: str, nonce_len: int, width: int, n_pad: int = 1) -> tuple:
    spec = build_tail_spec(bytes(nonce_len), width, get_hash_model(name))
    return (name, spec.n_blocks, spec.tb_loc, spec.chunk_locs, n_pad)


def _groups():
    """Every model at width 0, a one-block and a two-block tail."""
    out = []
    for name in MODELS:
        two = get_hash_model(name).block_bytes - 2
        out += [_gdef(name, 4, 0), _gdef(name, 4, 3, 4), _gdef(name, two, 2, 8)]
    assert any(g[1] == 2 for g in out) and any(not g[3] for g in out)
    return out


@pytest.mark.parametrize("caps,override,want", [
    (LaneCaps("cuda", 1), "auto", "cuda"),
    (LaneCaps("cuda", 4), "auto", "cuda"),
    (LaneCaps("cpu", 1), "auto", "torch"),
    (LaneCaps("cuda", 1), "torch", "torch"),
    (LaneCaps("cuda", 1), "xla", "torch"),
    (LaneCaps("cpu", 1), "cuda", "cuda"),
    (LaneCaps("cpu", 1), "pallas", "cuda"),
])
def test_rank_matrix(caps, override, want):
    planner = LanePlanner(caps=caps, override=override, device="cpu")
    for gdef in _groups():
        assert planner.rank(gdef, 1 << 20) == (want,), gdef


def test_cuda_device_resolves_every_group_to_the_group_kernel():
    """Width 0 and two-block tails included (the reference keeps width 0 on
    xla and rejects two-block tails from its pallas lane); the step is built
    once per key and covers the engine's batch."""
    planner = LanePlanner(caps=LaneCaps("cuda", 1), device="cpu")
    for gdef in _groups():
        lane, step = planner.resolve(gdef, 1 << 20)
        assert lane == "cuda" and step.lane == "cuda" and step.coverage == 1 << 20
        assert planner.resolve(gdef, 1 << 20)[1] is step
    assert LanePlanner(caps=LaneCaps("cpu", 1), device="cpu").resolve(
        _gdef("md5", 4, 2), 1 << 10) == ("torch", None)


def test_lane_names():
    assert {n: lane_name(n) for n in ("auto", "cuda", "pallas", "torch", "xla", None,
                                      "PALLAS")} == \
        {"auto": "auto", "cuda": "cuda", "pallas": "cuda", "torch": "torch", "xla": "torch",
         None: "auto", "PALLAS": "cuda"}
    with pytest.raises(ValueError, match="Queue 1 item 4"):
        lane_name("mesh")
    with pytest.raises(ValueError, match="Queue 1 item 4"):
        LanePlanner(caps=LaneCaps("cuda", 4), override="mesh")
    with pytest.raises(ValueError, match="unknown scheduler lane"):
        LanePlanner(caps=LaneCaps("cpu", 1), override="warp")


def test_cuda_group_step_guards():
    ok = _gdef("md5", 4, 2)
    assert build_cuda_group_step(ok, 4096, "cpu").coverage == 4096
    with pytest.raises(ValueError, match="unknown hash model"):
        build_cuda_group_step(("whirlpool",) + ok[1:], 4096, "cpu")
    with pytest.raises(ValueError, match="1 or 2 tail blocks"):
        build_cuda_group_step(("md5", 3) + ok[2:], 4096, "cpu")
    with pytest.raises(ValueError, match="multiple of 256"):
        build_cuda_group_step(ok, 4096 + 128, "cpu")
    with pytest.raises(ValueError, match="2\\^31"):
        build_cuda_group_step(ok, 1 << 31, "cpu")
    with pytest.raises(ValueError, match="contiguous run"):
        build_cuda_group_step(("md5", 1, (0, 1, 0), ((0, 3, 0),), 1), 4096, "cpu")
