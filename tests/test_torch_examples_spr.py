"""sparse_phase_retrieval's EP protocol past the SE transition, against the
JAX package on the same instances.

At alpha 0.81 and 1.2 (rho 0.6, prior mean 0.01) SE from a0 = 0.1 lies
well below the symmetric point (v 0.45; at 1.2 perfect recovery), but the
JAX script's EP protocol (EPSolver, damping 0.3, stop kind "r" at tol
1e-6, wait_increase 10) stops near the symmetric fixed point on most
seeds, and on every seed from N = 1000 on: the two packages agree on it. The seeds of one N as the lanes of one batched solve: equal
n_iter per lane, each seed's sign-symmetric mse rtol 1e-6, r within 1e-3
of the largest |r| (the batch tolerance). A seed has stalled where its mse
is above half its signal's power mean(x**2) (the symmetric point's mse).
The 8 seeds of N = 1000 at alpha 1.2 are in
tests/test_torch_examples_spr_n1000.py.
"""
import jax
import numpy as np
import pytest
import torch

import tramp_tpu as jt
from tramp_tpu.algos.metrics import sign_symmetric_mse
from tramp_tpu.experiments import BayesOptimalScenario as JScenario
from tramp_tpu.parallel import EPSolver as JEPSolver, stack_pytrees as jstack

from tramp_tpu_torch.examples.figures import sparse_phase_retrieval as spr

from torch_parity import assert_close, port_model, to_numpy


@pytest.mark.parametrize("N,alpha,seeds,stalled", [
    (500, 1.2, 3, 2), (1000, 0.81, 4, 4)], ids=["N500", "N1000-alpha0.81"])
def test_ep_past_the_se_transition_against_jax(N, alpha, seeds, stalled):
    hold_stalled_seeds(N, alpha, seeds, stalled)


def hold_stalled_seeds(N, alpha, seeds, stalled):
    """The seeds 0 .. seeds - 1 at (N, alpha) in both packages, and
    ``stalled`` of them near the symmetric point."""
    students, x_true = [], []
    for seed in range(seeds):
        model = jt.glm_generative(
            N=N, alpha=alpha, ensemble_type="gaussian",
            prior_type="gauss_bernoulli", output_type="abs",
            prior_rho=spr.RHO, prior_mean=0.01, key=jax.random.PRNGKey(seed))
        sc = JScenario(model, x_ids=["x"])
        sc.setup(seed=seed)
        students.append(sc.student)
        x_true.append(np.asarray(sc.x_true["x"]))
    post, n_iter = JEPSolver(students[0], **spr.EP_SOLVE).solve_batch(
        jstack(students))
    r = np.asarray(post["x"]["r"])
    want = [float(sign_symmetric_mse(x_true[i], r[i])) for i in range(seeds)]
    mses, p_post, p_n_iter = spr.ep_batch(
        [port_model(s) for s in students], [torch.tensor(x) for x in x_true])
    assert np.array_equal(to_numpy(p_n_iter), np.asarray(n_iter))
    assert_close(p_post["x"]["r"], r, 1e-3, "r")
    np.testing.assert_allclose(mses, want, rtol=1e-6)
    # SE lies below the symmetric point (at 1.2 it recovers); EP stops near
    # the symmetric point on `stalled` seeds
    se = spr.run_se_curve([alpha], spr.RHO, "SE", torch.device("cpu"))
    power = np.array([np.mean(x ** 2) for x in x_true])
    print(f"N={N}, alpha {alpha}: v_SE {se[0]['v']:.4g}, mse {np.round(want, 4).tolist()}, mean(x**2) "
          f"{np.round(power, 4).tolist()}, n_iter {np.asarray(n_iter)}")
    assert se[0]["v"] < (1e-6 if alpha == 1.2 else 0.5)
    assert int((np.array(want) > power / 2).sum()) == stalled
