"""The committee-binary denoiser with lanes against ``jax.vmap`` of the JAX
package's, float64 on the CPU: ``bx`` ``(B, N, K)`` (``(B, K)`` in the
``scalar_*`` methods) with a K x K precision per lane ``(B, K, K)``, and
``p_pos`` shared or one value per lane ``(B, 1)``.

Tolerance rtol 1e-12, relative to each element with a floor of rtol times
the largest magnitude (torch_parity.assert_close): one softmax over the
2^K spin configurations, summed in another order than JAX's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tramp_tpu.priors import CommitteeBinaryPrior as JCommitteeBinaryPrior

from tramp_tpu_torch.priors import CommitteeBinaryPrior

from torch_parity import assert_close

B, N, K = 3, 10, 3
RTOL = 1e-12


def _t(x):
    return torch.as_tensor(np.asarray(x), dtype=torch.float64)


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    m = rng.randn(B, K, K)
    ax = 1.5 * np.eye(K) + 0.1 * (m + m.transpose(0, 2, 1))
    return ax, rng.randn(B, N, K), rng.uniform(0.2, 0.8, B)


def _jax_lanes(method, ax, bx, p_pos, per_lane_p):
    "jax.vmap of the JAX denoiser's method over the lanes."
    def one(a, b, p):
        prior = JCommitteeBinaryPrior(N=N, K=K,
                                      p_pos=p if per_lane_p else 0.4)
        return getattr(prior, method)(a, b)
    return jax.vmap(one)(jnp.asarray(ax), jnp.asarray(bx),
                         jnp.asarray(p_pos))


@pytest.mark.parametrize("per_lane_p", [False, True])
def test_committee_binary_denoiser_with_lanes_matches_jax_vmap(per_lane_p):
    ax, bx, p_pos = _inputs()
    prior = CommitteeBinaryPrior(
        N=N, K=K, p_pos=_t(p_pos[:, None]) if per_lane_p else 0.4,
        device="cpu", dtype=torch.float64)
    rx, vx = prior.compute_forward_posterior(_t(ax), _t(bx))
    j_rx, j_vx = _jax_lanes("compute_forward_posterior", ax, bx, p_pos,
                            per_lane_p)
    assert rx.shape == (B, N, K) and vx.shape == (B, K, K)
    assert_close(rx, j_rx, RTOL, what="rx")
    assert_close(vx, j_vx, RTOL, what="vx")
    A = prior.compute_log_partition(_t(ax), _t(bx))
    assert A.shape == (B,)
    assert_close(A, _jax_lanes("compute_log_partition", ax, bx, p_pos,
                               per_lane_p), RTOL, what="logZ")
    for method, shape in (("scalar_forward_mean", (B, K)),
                          ("scalar_forward_variance", (B, K, K)),
                          ("scalar_log_partition", (B,))):
        got = getattr(prior, method)(_t(ax), _t(bx[:, 0]))
        assert got.shape == shape, method
        assert_close(got, _jax_lanes(method, ax, bx[:, 0], p_pos,
                                     per_lane_p), RTOL, what=method)


def test_a_lane_equals_its_single_instance():
    ax, bx, p_pos = _inputs(1)
    lanes = CommitteeBinaryPrior(N=N, K=K, p_pos=_t(p_pos[:, None]),
                                 device="cpu", dtype=torch.float64)
    rx, vx = lanes.compute_forward_posterior(_t(ax), _t(bx))
    A = lanes.compute_log_partition(_t(ax), _t(bx))
    for i in range(B):
        one = CommitteeBinaryPrior(N=N, K=K, p_pos=float(p_pos[i]),
                                   device="cpu", dtype=torch.float64)
        r_i, v_i = one.compute_forward_posterior(_t(ax[i]), _t(bx[i]))
        assert_close(rx[i], r_i, RTOL)
        assert_close(vx[i], v_i, RTOL)
        assert_close(A[i], one.compute_log_partition(_t(ax[i]), _t(bx[i])),
                     RTOL)
