"""MR1 and MR2 with their volumes sliced in the 'cs' and 'rs' planes,
against the JAX package, end to end (the families' 'rc' runs are in
tests/test_torch_port_families.py): raw inputs → eval preprocessing →
family → softmax through the port's ``make_predictor`` on the CPU against
the JAX preprocessing + ``apply`` + softmax, f32, ≤5e-4.
"""

import pytest

from torch_port_util import (FAMILY_AGG, FAMILY_DESS, FAMILY_TSE,
                             check_predictor_against_jax, family_cfg, mr_fe)

CASES = {
    "MR1CnnTrf-cs-maps": family_cfg("MR1CnnTrf", [FAMILY_DESS],
                                    mr_fe("cs", with_gap=False),
                                    dict(FAMILY_AGG, num_slices=None)),
    "MR1CnnTrf-rs": family_cfg("MR1CnnTrf", [FAMILY_DESS], mr_fe("rs"),
                               dict(FAMILY_AGG, num_slices=None)),
    "MR2CnnTrf-cs": family_cfg("MR2CnnTrf", [FAMILY_DESS, FAMILY_TSE],
                               mr_fe("cs"),
                               dict(FAMILY_AGG, num_slices=[4, 2])),
    "MR2CnnTrf-rs-maps": family_cfg("MR2CnnTrf", [FAMILY_DESS, FAMILY_TSE],
                                    mr_fe("rs", with_gap=False),
                                    dict(FAMILY_AGG, num_slices=[4, 2])),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_predictor_matches_jax_eval(case):
    check_predictor_against_jax(CASES[case])
