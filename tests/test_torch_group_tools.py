"""``distpow_tpu_torch.tools.compare_group`` on a machine without a GPU: it
exits 2 at once, and its check across turns holds only where every launch
gives the same words and md5's serving words are the plain group step's."""

import torch

from distpow_tpu_torch.ops.search_step import SENTINEL


def test_compare_group_tool_exits_without_a_gpu(capsys):
    from distpow_tpu_torch.tools import compare_group

    assert not torch.cuda.is_available()
    assert compare_group.main(["."]) == 2
    assert "no GPU" in capsys.readouterr().err


def test_compare_group_turns_agree_only_on_the_same_words():
    """Each model's rate words and md5's serving words the same in every
    turn, and the serving words the plain group step's."""
    from distpow_tpu_torch.tools.compare_group import agree

    def turn(rate=(SENTINEL, SENTINEL), serve=(5, SENTINEL), plain=(5, SENTINEL)):
        return {"rate": {"md5": {"words": list(rate)}, "sha1": {"words": [SENTINEL]}},
                "serve": {"words": list(serve), "plain": list(plain)}}

    assert agree([turn(), turn(), turn(), turn()])
    assert not agree([turn(), turn(rate=(7, SENTINEL)), turn(), turn()])
    assert not agree([turn(), turn(), turn(serve=(6, SENTINEL), plain=(6, SENTINEL)), turn()])
    assert not agree([turn(), turn(), turn(), turn(serve=(5, 9))])
    assert not agree([turn(plain=(4, SENTINEL))] * 4)


def test_group_variants_tool_exits_without_a_gpu(capsys):
    from distpow_tpu_torch.tools import group_variants

    assert not torch.cuda.is_available()
    assert group_variants.main([]) == 2
    assert "no GPU" in capsys.readouterr().err


def test_group_variants_patch_the_header_as_it_stands():
    """Each variant's change finds its text in ``hash_search.cuh``, and the
    slot-loop design replaces the whole of ``hash_group_block``."""
    import os

    from distpow_tpu_torch.tools import group_variants

    with open(os.path.join(group_variants.SRC, "hash_search.cuh")) as fh:
        header = fh.read()
    found = group_variants.variants()
    assert sorted(found) == ["as_built", "cell_at_start", "slot_loop", "waves1"]
    for name, changes in found.items():
        for old, new in changes:
            assert header.count(old) == 1 and new != old, name
    (old, new), = found["slot_loop"]
    assert old.startswith(group_variants.BLOCK[0]) and "slot_loop_move" in new
