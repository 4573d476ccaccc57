"""The cases of ``test_torch_mesh_step.py`` for the hashes of 128- and
136-byte blocks (sha512, sha384, sha3_256, blake2b_256): the port's mesh
steps against the reference's XLA mesh step on the CPU, exactly."""

import pytest

from test_torch_mesh_step import STEP_CASES, check_step_case

WIDE_MODELS = ("sha512", "sha384", "sha3_256", "blake2b_256")


@pytest.mark.parametrize("model_name", WIDE_MODELS)
@pytest.mark.parametrize("case", range(len(STEP_CASES)))
def test_wide_mesh_step_matches_the_reference_mesh_step(model_name, case):
    check_step_case(model_name, case)
