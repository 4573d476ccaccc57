"""``tools/compare_builds.py``'s verdict: a changed kernel's median pair
ratio against the spread of the kernels that compiled the same on both
sides."""

import pytest

from distpow_tpu_torch.tools.compare_builds import verdicts


def _row(model, ratios, same=True):
    ratios = list(ratios)
    return {"model": model, "same_registers": same, "same_loop_lengths": same,
            "pair_ratios": ratios, "this_over_other": sorted(ratios)[len(ratios) // 2]}


CONTROLS = [_row("md5", (0.98, 1.01, 0.99)), _row("sha1", (0.97, 1.02, 1.00))]


@pytest.mark.parametrize("ratios,verdict", [
    ((0.93, 0.94, 0.95), "faster"),       # below every control pair
    ((0.96, 0.98, 0.99), "unresolved"),   # inside the controls' spread
    ((1.03, 1.04, 1.05), "slower"),       # above every control pair
])
def test_changed_kernel_judged_against_controls(ratios, verdict):
    out = verdicts([*CONTROLS, _row("sha512", ratios, same=False)])
    assert out["controls"] == ["md5", "sha1"]
    assert out["control_spread"] == [0.97, 1.02]
    assert out["changed"] == {"sha512": {"this_over_other": sorted(ratios)[1],
                                         "verdict": verdict}}


def test_no_controls_leaves_every_change_unresolved():
    out = verdicts([_row("sha512", (0.5, 0.5, 0.5), same=False)])
    assert out["control_spread"] is None
    assert out["changed"]["sha512"]["verdict"] == "unresolved"
