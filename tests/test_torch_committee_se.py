"""The committees' state evolution, tramp_tpu_torch against tramp_tpu,
float64 on the CPU: ``StateEvolution`` of the soft and sign committees
(N = 40), whose sum channel takes a list of K precisions and returns one
per input: equal n_iter, every variable's v at rtol 1e-10.
"""
import pytest

import tramp_tpu as jt

import tramp_tpu_torch as tt

from torch_parity import assert_close, committee_case


@pytest.mark.parametrize("kind", ["soft", "sgn"])
def test_committee_state_evolution_matches_jax(kind):
    j_student, student, _ = committee_case(kind)
    se = tt.StateEvolution(student, device="cpu").iterate(max_iter=100)
    j_se = jt.StateEvolution(j_student)
    j_se.iterate(max_iter=100)
    assert se.n_iter == j_se.n_iter
    for id, d in j_se.get_variables_data().items():
        assert_close(se.get_variable_data(id)["v"], d["v"], 1e-10, what=id)
