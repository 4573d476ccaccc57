"""The port's lane planner (``distpow_tpu_torch/sched/lanes.py``) with
injected capabilities, so the matrix runs without a card: on a CUDA device
the ``cuda`` lane (the group kernel) takes every group, width-0 and
two-block tails included, also where there is more than one shard
(``auto`` never picks ``mesh``); on the CPU the ``torch`` lane; ``mesh``
when asked for, except for width 0; the reference's lane names map onto the port's; unknown names
raise; the group checks refuse what the kernel cannot take, and nothing
demotes."""

import types

import pytest
import torch

from distpow_tpu_torch.models.registry import get_hash_model
from distpow_tpu_torch.ops.packing import build_tail_spec
from distpow_tpu_torch.parallel.mesh_search import make_mesh
from distpow_tpu_torch.sched.lanes import LaneCaps, LanePlanner, check_group, lane_name, mesh_span

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


@pytest.mark.parametrize("caps,override,want,want_w0", [
    (LaneCaps("cuda", 1), "auto", ("cuda",), ("cuda",)),
    (LaneCaps("cuda", 4), "auto", ("cuda",), ("cuda",)),
    (LaneCaps("cpu", 1), "auto", ("torch",), ("torch",)),
    (LaneCaps("cpu", 4), "auto", ("torch",), ("torch",)),
    (LaneCaps("cuda", 1), "torch", ("torch",), ("torch",)),
    (LaneCaps("cuda", 1), "xla", ("torch",), ("torch",)),
    (LaneCaps("cpu", 1), "cuda", ("cuda",), ("cuda",)),
    (LaneCaps("cpu", 1), "pallas", ("cuda",), ("cuda",)),
    (LaneCaps("cuda", 1), "mesh", ("mesh", "cuda"), ("cuda",)),
    (LaneCaps("cpu", 4), "mesh", ("mesh", "torch"), ("torch",)),
])
def test_rank_matrix(caps, override, want, want_w0):
    """Eligible lanes, first first; width 0 (no chunk bytes) never goes to
    the mesh lane."""
    planner = LanePlanner(caps=caps, override=override, device="cpu")
    for gdef in _groups():
        assert planner.rank(gdef, 1 << 20) == (want if gdef[3] else want_w0), gdef


def test_cuda_device_resolves_every_group_to_the_group_kernel():
    """Width 0 and two-block tails included (the reference keeps width 0 on
    xla and rejects two-block tails from its pallas lane), with more than
    one shard too (auto never picks the mesh); a launch covers the engine's
    batch."""
    for caps in (LaneCaps("cuda", 1), LaneCaps("cuda", 4)):
        planner = LanePlanner(caps=caps, device="cpu")
        for gdef in _groups():
            assert planner.resolve(gdef, 1 << 20) == ("cuda", 1 << 20)
    assert LanePlanner(caps=LaneCaps("cpu", 1), device="cpu").resolve(
        _gdef("md5", 4, 2), 1 << 10) == ("torch", 1 << 10)


def test_mesh_lane_covers_every_shard_and_span():
    """lane="mesh" on CPU shards: a launch covers n_shards x mesh_span() x
    batch a slot (the reference's coverage); width 0 stays on the device's
    lane; the mesh's first device must be the scheduler's; a mesh too wide
    for 2^31 candidates is not eligible."""
    mesh = make_mesh(["cpu"] * 3)
    planner = LanePlanner(override="mesh", device="cpu", mesh=mesh)
    assert planner.caps == LaneCaps("cpu", 3) and planner.mesh is mesh
    for gdef in _groups():
        want = ("mesh", 3 * mesh_span() * 4096) if gdef[3] else ("torch", 4096)
        assert planner.resolve(gdef, 4096) == want, gdef
    assert planner.rank(_gdef("md5", 4, 2), -(-(1 << 31) // (3 * mesh_span()))) == ("torch",)
    elsewhere = types.SimpleNamespace(devices=(torch.device("cuda", 1),), size=1)
    with pytest.raises(ValueError, match="first device"):
        LanePlanner(override="mesh", device="cpu", mesh=elsewhere)
    # auto on the CPU keeps the torch lane, whatever the mesh
    assert LanePlanner(device="cpu", mesh=mesh).resolve(_gdef("md5", 4, 2), 4096) == \
        ("torch", 4096)


def test_lane_names():
    assert {n: lane_name(n) for n in ("auto", "cuda", "pallas", "torch", "xla", None,
                                      "PALLAS", "mesh", "MESH")} == \
        {"auto": "auto", "cuda": "cuda", "pallas": "cuda", "torch": "torch", "xla": "torch",
         None: "auto", "PALLAS": "cuda", "mesh": "mesh", "MESH": "mesh"}
    assert LanePlanner(caps=LaneCaps("cuda", 4), override="mesh", device="cpu").override == "mesh"
    with pytest.raises(ValueError, match="unknown scheduler lane"):
        LanePlanner(caps=LaneCaps("cpu", 1), override="warp")


def test_cuda_group_step_guards():
    ok = _gdef("md5", 4, 2)
    check_group(ok, 4096)
    with pytest.raises(ValueError, match="unknown hash model"):
        check_group(("whirlpool",) + ok[1:], 4096)
    with pytest.raises(ValueError, match="1 or 2 tail blocks"):
        check_group(("md5", 3) + ok[2:], 4096)
    with pytest.raises(ValueError, match="multiple of 256"):
        check_group(ok, 4096 + 128)
    with pytest.raises(ValueError, match="2\\^31"):
        check_group(ok, 1 << 31)
    with pytest.raises(ValueError, match="contiguous run"):
        check_group(("md5", 1, (0, 1, 0), ((0, 3, 0),), 1), 4096)
    # the planner runs the same checks before it names a kernel lane
    with pytest.raises(ValueError, match="multiple of 256"):
        LanePlanner(caps=LaneCaps("cuda", 1), device="cpu").resolve(ok, 4096 + 128)
