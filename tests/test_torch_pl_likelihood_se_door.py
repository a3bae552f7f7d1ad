"""The state evolution of the symmetric-door likelihood (three flat regions), tramp_tpu_torch against tramp_tpu,
float64 on the CPU, as tests/test_torch_likelihoods_se.py holds the sign,
abs and modulus likelihoods and with its tolerances: the SE methods over
its (az, tau_z) grid at rtol 1e-9 (the overlap and the SE update to 1e-9
times tau_z and az), ``b_measure`` and ``bz_measure`` of a plain
integrand, a plain integrand's beliefs measure, and a precision per lane
against lane-by-lane calls at 1e-12. One file per likelihood or two: the
JAX side's first calls compile for seconds. Also the door GLM (binary
prior) of tests/test_torch_glm_outputs.py: 4 SE sweeps against JAX, every
slot at rtol 1e-9.
"""
import pytest

from test_torch_glm_outputs import check_sweeps
from test_torch_likelihoods_se import (
    AZ_TAU, check_beliefs_measure_of_a_plain_integrand, check_bo_rs_measures,
    check_se_lanes, check_se_methods, jax_se_methods,
)

NAMES = ['door']


@pytest.fixture(scope="module")
def jax_se():
    return jax_se_methods(NAMES)


@pytest.mark.parametrize("az,tau_z", AZ_TAU)
@pytest.mark.parametrize("name", NAMES)
def test_likelihood_se_methods(name, az, tau_z, jax_se):
    check_se_methods(name, az, tau_z, jax_se)


@pytest.mark.parametrize("name", NAMES)
def test_likelihood_bo_rs_measures(name):
    check_bo_rs_measures(name, potentials=False)


@pytest.mark.parametrize("name", NAMES)
def test_likelihood_beliefs_measure_of_a_plain_integrand(name):
    check_beliefs_measure_of_a_plain_integrand(name)


@pytest.mark.parametrize("name", NAMES)
def test_likelihood_se_lanes_equal_single_calls(name):
    check_se_lanes(name)


def test_door_glm_state_evolution_sweeps_match_jax():
    check_sweeps("door")
