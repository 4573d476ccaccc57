"""md5's libraries, one per tail layout: the build's library names and
paths (``ops/_build.py``), which layouts the wrapper accepts for md5
(``ops/hash_cuda.py`` ``kernel_layout``, ``check_tail``), and what
``load_kernels`` builds for a backend's warm-up.  Host-side only: nothing
here runs nvcc."""

import pytest

from distpow_tpu_torch.models.registry import MD5, get_hash_model
from distpow_tpu_torch.ops import _build, hash_cuda
from distpow_tpu_torch.ops.hash_cuda import KEYED_LAYOUTS, check_tail, kernel_layout
from distpow_tpu_torch.ops.packing import build_tail_spec


def test_libraries_expand_md5_per_var_word():
    libs = _build.libraries()
    assert [k for k in libs if k.startswith("md5")] == [f"md5_search.vw{w}" for w in range(16)]
    assert "md5_search" not in libs
    others = [s for s in _build.sources() if s != "md5_search"]
    assert len(others) == 8 and all(s in libs for s in others)
    assert _build.libraries(["md5_search.vw3", "sha1_search"]) == ["md5_search.vw3",
                                                                   "sha1_search"]


@pytest.mark.parametrize("name,var_word", [("md5_search", None), ("md5_search", 16),
                                           ("md5_search", -1), ("sha1_search", 1)])
def test_library_key_rejects_a_layout_with_no_library(name, var_word):
    with pytest.raises(ValueError):
        _build.library_key(name, var_word)


def test_library_paths_differ_per_var_word():
    """Each var_word's library is its own file (its -D flag is in the
    hash), and the other sources keep one each."""
    paths = {_build.library_path(k) for k in _build.libraries()}
    assert len(paths) == len(_build.libraries())
    assert _build.library_path("md5_search.vw1").split("/")[-1].startswith("libmd5_search.vw1_")
    assert _build._split("md5_search.vw12") == ("md5_search", ["-DDISTPOW_VAR_WORD=12"])
    assert _build._split("sha256_search") == ("sha256_search", [])


def test_kernel_layout_and_launch_check_take_only_built_md5_layouts():
    """A run in the second block (var_word 16 or more) has no md5 kernel;
    a one-block tail's run starts at word 13 at the latest, a two-block
    tail's anywhere in the first block.  Other models take any word."""
    with pytest.raises(ValueError, match="no md5 kernel"):
        kernel_layout((1, 0, 0), ((1, 0, 8),), MD5)
    assert kernel_layout((0, 15, 24), ((1, 0, 0),), MD5)[0] == 15
    for n_blocks, var_words in KEYED_LAYOUTS["md5"].items():
        for w in range(16):
            if w in var_words:
                check_tail(MD5, n_blocks, w, (0, w, 0))
            else:
                with pytest.raises(ValueError, match="no md5 kernel"):
                    check_tail(MD5, n_blocks, w, (0, w, 0))
    check_tail(get_hash_model("sha1"), 1, 14, (0, 14, 0))
    with pytest.raises(ValueError, match="outside"):
        check_tail(get_hash_model("sha1"), 1, 16, (1, 0, 0))


def test_load_kernels_builds_the_served_layouts_at_once(monkeypatch):
    """md5: one build call for the var_words of the tails asked for, then
    each library loaded; another model: its one library."""
    calls = []
    monkeypatch.setattr(_build, "build", lambda names: calls.append(("build", list(names))))
    monkeypatch.setattr(_build, "load_library",
                        lambda name, var_word=None: calls.append(("load", name, var_word)))
    tails = [build_tail_spec(bytes(n), w, MD5) for n in (4, 30, 60) for w in (0, 2, 4)]
    hash_cuda.load_kernels(MD5, [(t.tb_loc, t.chunk_locs) for t in tails])
    words = sorted({kernel_layout(t.tb_loc, t.chunk_locs, MD5)[0] for t in tails})
    assert words == [1, 7, 15]
    assert calls == [("build", [f"md5_search.vw{w}" for w in words])] + \
        [("load", "md5_search", w) for w in words]
    calls.clear()
    hash_cuda.load_kernels(get_hash_model("sha1"), [(t.tb_loc, t.chunk_locs) for t in tails])
    assert calls == [("load", "sha1_search", None)]
