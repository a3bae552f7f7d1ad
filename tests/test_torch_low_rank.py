"""The low-rank family, tramp_tpu_torch against tramp_tpu, float64 on the
CPU: the embedded VAMP solver, its state evolution and the two channels.

- The solver step by step: ``max_iter = t, min_iter = t + 1, tol = 0`` runs
  exactly t + 1 iterations of the loop on both sides; every marginal at
  rtol 1e-10, for t = 0, 1, 4 and both models (UV and the Gram XX). At its
  fixed point (Delta = 0.5, where the reference converges,
  tests/test_low_rank_activation.py:93-107) at rtol 1e-8.
- 3 lanes (``bx (3, M, N)``, ``ax (3, 1, 1)``, a Delta each) in one call:
  lane i equals the port's single solve of lane i (rtol 1e-12) and the JAX
  solve (rtol 1e-8); the lanes stop at different iterations.
- The K x K and the scalar SE against the JAX functions at rtol 1e-10.
- Both channels' posteriors and messages against JAX at rtol 1e-8, with
  nonzero prior means, and 3 lanes against the single calls.

The solver's fixed point is compared only where its own stop fires: from
these inputs the loop is chaotic until it settles (tests/
test_low_rank_activation.py:390-432), and a solve that runs its 500
iterations ends at a rounding-dependent point in both packages.

The engine paths (tests/test_low_rank_activation.py:326-388) are in
tests/test_torch_low_rank_ep.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tramp_tpu.channels import low_rank as jlr

from tramp_tpu_torch.channels import (
    LowRankFactorization, LowRankGramChannel, get_channel)
from tramp_tpu_torch.channels import low_rank as lr

from torch_parity import assert_close

F64 = torch.float64
CPU = dict(device="cpu", dtype=F64)


def _t(x):
    return torch.as_tensor(np.asarray(x), dtype=F64)


def _uv(seed=3, M=40, N=60, K=2, Delta=0.5, gram=False):
    """(ax, bx, bu, bv) of a planted instance drawn as the reference-parity
    test draws it (tests/test_low_rank_activation.py:93-107), numpy: at
    Delta >= 0.5 the solver converges from these prior means."""
    rng = np.random.RandomState(seed)
    u0 = rng.randn(M, K)
    v0 = u0 if gram else rng.randn(N, K)
    E = rng.randn(M, N)
    noise = (E + E.T) / np.sqrt(2) if gram else E
    Y = u0 @ v0.T / np.sqrt(N) + np.sqrt(Delta) * noise
    bu = rng.randn(M, K)
    bv = bu if gram else rng.randn(N, K)
    return 1.0 / Delta, Y / Delta, bu, bv


def _both(model, au, av, bu, bv, ax, bx, **kw):
    got = lr.vamp_matrix_factorization(
        au=au, av=av, bu=_t(bu), bv=_t(bv), ax=ax, bx=_t(bx), model=model,
        return_marginals=True, **kw)
    want = jlr.vamp_matrix_factorization(
        au=au, av=av, bu=jnp.asarray(bu), bv=jnp.asarray(bv), ax=ax,
        bx=jnp.asarray(bx), model=model, return_marginals=True, **kw)
    return got, want


def _hold(got, want, rtol, what):
    for name, g, w in zip(("rz_u", "vz_u", "rz_v", "vz_v"), got[:4],
                          want[:4]):
        assert_close(g, w, rtol, what=f"{what} {name}")
    for name, g, w in zip(("U", "C_U", "V", "C_V"), got[4], want[4]):
        assert_close(g, w, rtol, what=f"{what} {name}")


@pytest.mark.parametrize("model", ["UV", "XX"])
@pytest.mark.parametrize("t", [0, 1, 4])
def test_solver_step_by_step(model, t):
    gram = model == "XX"
    M, N, K = (50, 50, 2) if gram else (40, 60, 2)
    ax, bx, bu, bv = _uv(M=M, N=N, K=K, gram=gram)
    au, av = 1.3, 1.3 if gram else 0.8
    got, want = _both(model, au, av, bu, bv, ax, bx, max_iter=t,
                      min_iter=t + 1, tol=0.0)
    _hold(got, want, 1e-10, f"{model} t={t}")


@pytest.mark.parametrize("model", ["UV", "XX"])
def test_solver_fixed_point(model):
    gram = model == "XX"
    M, N, K = (50, 50, 2) if gram else (40, 60, 2)
    ax, bx, bu, bv = _uv(M=M, N=N, K=K, gram=gram)
    au = av = 1.0
    stats = {}
    got = lr.vamp_matrix_factorization(
        au=au, av=av, bu=_t(bu), bv=_t(bv), ax=ax, bx=_t(bx), model=model,
        return_marginals=True, stats=stats)
    want = jlr.vamp_matrix_factorization(
        au=au, av=av, bu=jnp.asarray(bu), bv=jnp.asarray(bv), ax=ax,
        bx=jnp.asarray(bx), model=model, return_marginals=True)
    # converged: the reference's own stop fires (64 iterations for UV)
    assert stats["solves"] == 1 and 25 < stats["iterations"] < 200
    _hold(got, want, 1e-8, model)


def test_solver_lanes_against_single_solves():
    M, N, K = 40, 60, 2
    bxs, axs = [], []
    for Delta in (0.5, 0.7, 1.0):
        ax, bx, bu, bv = _uv(M=M, N=N, K=K, Delta=Delta)
        bxs.append(bx)
        axs.append(ax)
    au, av = 1.0, 1.0
    stats = {}
    got = lr.vamp_matrix_factorization(
        au=au, av=av, bu=_t(bu), bv=_t(bv),
        ax=_t(np.reshape(axs, (3, 1, 1))), bx=_t(np.stack(bxs)), model="UV",
        return_marginals=True, stats=stats)
    assert got[0].shape == (3, M, K) and got[1].shape == (3, 1, 1)
    steps = []
    for i in range(3):
        one = {}
        single = lr.vamp_matrix_factorization(
            au=au, av=av, bu=_t(bu), bv=_t(bv), ax=axs[i], bx=_t(bxs[i]),
            model="UV", return_marginals=True, stats=one)
        steps.append(one["iterations"])
        want = jlr.vamp_matrix_factorization(
            au=au, av=av, bu=jnp.asarray(bu), bv=jnp.asarray(bv), ax=axs[i],
            bx=jnp.asarray(bxs[i]), model="UV", return_marginals=True)
        lane = [x[i] for x in got[:4]] + [[x[i] for x in got[4]]]
        lane[1], lane[3] = lane[1].reshape(()), lane[3].reshape(())
        _hold(lane, single, 1e-12, f"lane {i} vs single")
        _hold(lane, want, 1e-8, f"lane {i} vs JAX")
    # the batch runs to its slowest lane, each lane stops at its own step
    # (64, 29 and 27 iterations)
    assert stats["iterations"] == max(steps) and len(set(steps)) == 3


def test_forward_posterior_from_marginals():
    M, N, K = 30, 45, 2
    ax, bx, _, _ = _uv(seed=4, M=M, N=N, K=K, Delta=0.1)
    *_, marg = jlr.vamp_matrix_factorization(
        au=1.0, av=1.0, bu=jnp.zeros((M, K)), bv=jnp.zeros((N, K)), ax=ax,
        bx=jnp.asarray(bx), model="UV", return_marginals=True)
    got = lr.forward_posterior_from_marginals(
        *(_t(m) for m in marg), N)
    want = jlr.forward_posterior_from_marginals(*marg, N)
    for g, w in zip(got, want):
        assert_close(g, w, 1e-12)
    lanes = lr.forward_posterior_from_marginals(
        *(torch.stack([_t(m)] * 2) for m in marg), N)
    assert lanes[1].shape == (2, 1, 1)
    assert_close(lanes[1][1].reshape(()), want[1], 1e-12)


@pytest.mark.parametrize("model", ["UV", "XX"])
def test_state_evolution(model):
    for ax, damping in ((2.0, 0.0), (5.0, 0.5), (10.0, 0.8)):
        got = lr.se_matrix_factorization_kk(
            au=1.0, av=1.0, ax=ax, model=model, K=2, alpha=0.75,
            damping=damping, **CPU)
        want = jlr.se_matrix_factorization_kk(
            au=1.0, av=1.0, ax=ax, model=model, K=2, alpha=0.75,
            damping=damping)
        for g, w in zip(got, want):
            assert_close(g, w, 1e-10, what=f"kk ax={ax}")
        got = lr.se_matrix_factorization(au=1.2, av=0.9, ax=ax, model=model,
                                         K=2, N=100, M=75, **CPU)
        want = jlr.se_matrix_factorization(au=1.2, av=0.9, ax=ax,
                                           model=model, K=2, N=100, M=75)
        for g, w in zip(got if model == "UV" else [got],
                        want if model == "UV" else [want]):
            assert_close(g, w, 1e-10, what=f"scalar ax={ax}")
    # prior means and a seeded init, one step at a time
    lam = jnp.asarray([1.0, -0.5])
    q0 = np.array([[0.7, 0.1], [0.1, 0.6]])
    for t in (1, 3):
        got = lr.se_matrix_factorization_kk(
            au=1.0, av=1.0, ax=2.0, model=model, K=2, lam_u=np.asarray(lam),
            lam_v=np.asarray(lam), q0_u=q0, q0_v=q0, max_iter=t,
            min_iter=t + 1, tol=0.0, **CPU)
        want = jlr.se_matrix_factorization_kk(
            au=1.0, av=1.0, ax=2.0, model=model, K=2, lam_u=lam, lam_v=lam,
            q0_u=jnp.asarray(q0), q0_v=jnp.asarray(q0), max_iter=t,
            min_iter=t + 1, tol=0.0)
        for g, w in zip(got, want):
            assert_close(g, w, 1e-12, what=f"kk step {t}")


def _channels(kind):
    "(JAX channel, port channel, x shape) at sizes where the solve converges."
    if kind == "factorization":
        from tramp_tpu.channels import LowRankFactorization as J
        M, N, K = 40, 60, 2
        return J(M=M, N=N, K=K), LowRankFactorization(M=M, N=N, K=K), (M, N)
    from tramp_tpu.channels import LowRankGramChannel as J
    N, K = 50, 2
    return J(N=N, K=K), LowRankGramChannel(N=N, K=K), (N, N)


@pytest.mark.parametrize("kind", ["factorization", "gram"])
def test_channel_posteriors(kind):
    """Posteriors and messages on an instance where the embedded solve
    converges (Delta 0.5: 64 iterations UV, 42 XX)."""
    jc, ch, (M, N) = _channels(kind)
    K = ch.K
    ax, bx, bu, bv = _uv(M=M, N=N, K=K, gram=kind == "gram")
    if kind == "factorization":
        az, bz = [1.0, 1.0], [bu, bv]
        p_az, p_bz = [_t(a) for a in az], [_t(b) for b in bz]
        j_bz = [jnp.asarray(b) for b in bz]
    else:
        az, bz = 1.0, bu
        p_az, p_bz, j_bz = _t(az), _t(bz), jnp.asarray(bz)

    def flat(out):
        return [x for part in out
                for x in (part if isinstance(part, list) else [part])]

    for method in ("compute_forward_posterior", "compute_backward_posterior",
                   "compute_forward_message", "compute_backward_message"):
        got = getattr(ch, method)(p_az, p_bz, _t(ax), _t(bx))
        want = getattr(jc, method)(az, j_bz, ax, jnp.asarray(bx))
        for g, w in zip(flat(got), flat(want)):
            assert_close(g, w, 1e-8, what=f"{kind} {method}")
    # SE and the second moment
    if kind == "factorization":
        got = ch.compute_backward_error([_t(1.0), _t(1.0)], _t(3.0), None)
        want = jc.compute_backward_error([1.0, 1.0], 3.0, None)
        for g, w in zip(got, want):
            assert_close(g, w, 1e-10)
        assert ch.second_moment(1.0, 2.0) == jc.second_moment(1.0, 2.0)
    else:
        assert_close(ch.compute_backward_error(_t(1.0), _t(3.0), None),
                     jc.compute_backward_error(1.0, 3.0, None), 1e-10)


def test_factorization_lanes():
    "3 lanes through the channel: lane i = the single call on lane i."
    rng = np.random.RandomState(7)
    M, N, K = 20, 30, 2
    ch = LowRankFactorization(M=M, N=N, K=K)
    au, av = rng.uniform(0.8, 1.2, (3, 1, 1)), rng.uniform(0.8, 1.2, (3, 1, 1))
    lanes = [_uv(seed=s, M=M, N=N, K=K) for s in (3, 4, 5)]
    ax = np.reshape([lane[0] for lane in lanes], (3, 1, 1))
    bx, bu, bv = (np.stack([lane[j] for lane in lanes]) for j in (1, 2, 3))
    rx, vx = ch.compute_forward_posterior([_t(au), _t(av)], [_t(bu), _t(bv)],
                                          _t(ax), _t(bx))
    (ru, rv), (vu, vv) = ch.compute_backward_posterior(
        [_t(au), _t(av)], [_t(bu), _t(bv)], _t(ax), _t(bx))
    assert vx.shape == vu.shape == (3, 1, 1) and rx.shape == (3, M, N)
    for i in range(3):
        one = LowRankFactorization(M=M, N=N, K=K)
        args = ([_t(au[i, 0, 0]), _t(av[i, 0, 0])], [_t(bu[i]), _t(bv[i])],
                _t(ax[i, 0, 0]), _t(bx[i]))
        r1, v1 = one.compute_forward_posterior(*args)
        assert_close(rx[i], r1, 1e-12)
        assert_close(vx[i, 0, 0], v1, 1e-12)
        (u1, w1), (a1, b1) = one.compute_backward_posterior(*args)
        assert_close(ru[i], u1, 1e-12)
        assert_close(rv[i], w1, 1e-12)
        assert_close(vu[i, 0, 0], a1, 1e-12)
        assert_close(vv[i, 0, 0], b1, 1e-12)


def test_registry_and_sample():
    ch = get_channel("low_rank_factorization", M=20, N=30, K=2)
    x = ch.sample(None, torch.ones(20, 2, dtype=F64),
                  torch.ones(30, 2, dtype=F64))
    assert x.shape == (20, 30)
    np.testing.assert_allclose(float(ch.second_moment(1.0, 1.0)), 2 / 30)
    assert get_channel("low_rank_gram", N=5, K=2).out_shape((5, 2)) == (5, 5)
