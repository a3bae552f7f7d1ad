"""The remaining priors, tramp_tpu_torch against tramp_tpu, float64 on the
CPU: binary, Gaussian, exponential (also registered as "positive"),
positive, Gaussian mixture, MAP L1 / L2,1 and committee-binary. For each,
the EP posterior and message, the log partition and the second moment; MAP
priors with a gamma per lane against lane-by-lane calls; the committee
prior refusing lanes; and the rebuild from the JAX factor's fields
(tramp_tpu_torch.convert). Their state evolution is in
tests/test_torch_priors_se.py.

Tolerances (torch_parity.assert_close):
- EP posteriors, messages, log partitions: rtol 1e-12 (the same formulas);
  the positive and exponential priors' variances, v0 (1 + g2 - g1^2) per
  element, cancel: their isotropic means are held at 1e-10;
- lanes against lane-by-lane calls, in the port: 1e-12.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tramp_tpu import priors as jpriors

from tramp_tpu_torch import convert, priors

from torch_parity import assert_close, describe_factor

F64 = torch.float64
RTOL = 1e-12

# name: (class name, keywords); the same on both sides
PRIORS = {
    "binary": ("BinaryPrior", dict(p_pos=0.3)),
    "gaussian": ("GaussianPrior", dict(mean=0.4, var=1.7)),
    "exponential": ("ExponentialPrior", dict(mean=0.7)),
    "positive": ("PositivePrior", {}),
    "mixture": ("GaussianMixturePrior",
                dict(probs=(0.3, 0.7), means=(-1.0, 0.5), vars=(0.5, 1.5))),
}


def _t(x):
    return torch.as_tensor(np.asarray(x), dtype=F64)


def _col(values):
    return torch.as_tensor(np.asarray(values), dtype=F64).reshape(-1, 1)


def _pair(name, size=1, **extra):
    "The port's and the JAX package's prior ``name`` (PRIORS)."
    cls, kw = PRIORS[name]
    kw = dict(kw, **extra)
    port_kw = dict(device="cpu", dtype=F64)
    return (getattr(priors, cls)(size=size, **kw, **port_kw),
            getattr(jpriors, cls)(size=size, **kw))


def test_registry_has_every_jax_prior_type():
    assert set(priors.PRIOR_CLASSES) == set(jpriors.PRIOR_CLASSES)
    for key, cls in jpriors.PRIOR_CLASSES.items():
        assert priors.PRIOR_CLASSES[key].__name__ == cls.__name__, key
    assert not hasattr(priors, "_WAITING")


@pytest.mark.parametrize("isotropic", [True, False])
@pytest.mark.parametrize("name", list(PRIORS))
def test_prior_ep(name, isotropic):
    n = 48
    port, ref = _pair(name, size=n, isotropic=isotropic)
    rng = np.random.RandomState(5)
    bx = 2 * rng.randn(n)
    ax = 1.3
    rtol_v = 1e-10 if name in ("positive", "exponential") else RTOL
    for method in ("compute_forward_posterior", "compute_forward_message"):
        got = getattr(port, method)(_t(ax), _t(bx))
        want = getattr(ref, method)(ax, jnp.asarray(bx))
        for k, (g, w) in enumerate(zip(got, want)):
            rtol = rtol_v if (method, k) == ("compute_forward_posterior", 1) \
                else RTOL
            if method == "compute_forward_message" and name in (
                    "positive", "exponential"):
                rtol = 1e-10
            assert_close(g, w, rtol, what=f"{method} {k}")
    assert_close(port.compute_log_partition(_t(ax), _t(bx)),
                 ref.compute_log_partition(ax, jnp.asarray(bx)), RTOL)
    assert float(port.second_moment()) == pytest.approx(
        float(ref.second_moment()), rel=1e-15)
    x = port.sample(torch.Generator().manual_seed(0))
    assert x.shape == (n,) and x.dtype == F64 and bool(torch.isfinite(x).all())


@pytest.mark.parametrize("name", ["L1", "L21"])
def test_map_priors(name):
    rng = np.random.RandomState(7)
    if name == "L1":
        size, kw = 40, dict(gamma=1.5)
        port = priors.MAP_L1NormPrior(size=size, device="cpu", **kw)
        ref = jpriors.MAP_L1NormPrior(size=size, **kw)
        shape = (size,)
    else:
        size, kw = (6, 5), dict(gamma=0.8, axis=1)
        port = priors.MAP_L21NormPrior(size=size, device="cpu", **kw)
        ref = jpriors.MAP_L21NormPrior(size=size, **kw)
        shape = size
    bx, ax = 2 * rng.randn(*shape), 1.7
    for got, want in zip(port.compute_forward_posterior(_t(ax), _t(bx)),
                         ref.compute_forward_posterior(ax, jnp.asarray(bx))):
        assert_close(got, want, RTOL)
    for got, want in zip(port.compute_forward_message(_t(ax), _t(bx)),
                         ref.compute_forward_message(ax, jnp.asarray(bx))):
        assert_close(got, want, RTOL)
    assert_close(port.compute_log_partition(_t(ax), _t(bx)),
                 ref.compute_log_partition(ax, jnp.asarray(bx)), RTOL)
    # three lanes, a gamma and a precision each, against their single calls
    gammas, axs = [0.5, 1.5, 3.0], [0.7, 1.7, 4.0]
    laned = type(port)(size=size, gamma=_col(gammas).reshape(
        (3,) + (1,) * len(shape)), device="cpu", **(
        {"axis": 1} if name == "L21" else {}))
    bxs = _t(2 * rng.randn(3, *shape))
    a = _col(axs).reshape((3,) + (1,) * len(shape))
    r, v = laned.compute_forward_posterior(a, bxs)
    A = laned.compute_log_partition(a, bxs)
    for i in range(3):
        one = type(port)(size=size, gamma=gammas[i], device="cpu", **(
            {"axis": 1} if name == "L21" else {}))
        r_i, v_i = one.compute_forward_posterior(_t(axs[i]), bxs[i])
        assert_close(r[i], r_i, 1e-12)
        assert_close(v[i].reshape(()), v_i, 1e-12)
        assert_close(A[i].reshape(()), one.compute_log_partition(
            _t(axs[i]), bxs[i]), 1e-12)


def test_committee_binary_prior_one_instance():
    N, K = 12, 3
    port = priors.CommitteeBinaryPrior(N=N, K=K, p_pos=0.4, device="cpu")
    ref = jpriors.CommitteeBinaryPrior(N=N, K=K, p_pos=0.4)
    rng = np.random.RandomState(4)
    m = rng.randn(K, K)
    ax = np.eye(K) * 1.5 + 0.1 * (m + m.T)
    bx = rng.randn(N, K)
    for got, want in zip(port.compute_forward_posterior(_t(ax), _t(bx)),
                         ref.compute_forward_posterior(jnp.asarray(ax),
                                                       jnp.asarray(bx))):
        assert_close(got, want, RTOL)
    assert_close(port.compute_log_partition(_t(ax), _t(bx)),
                 ref.compute_log_partition(jnp.asarray(ax), jnp.asarray(bx)),
                 RTOL)
    for method in ("scalar_forward_mean", "scalar_forward_variance",
                   "scalar_log_partition"):
        assert_close(getattr(port, method)(_t(ax), _t(bx[0])),
                     getattr(ref, method)(jnp.asarray(ax),
                                          jnp.asarray(bx[0])), RTOL,
                     what=method)
    x = port.sample(torch.Generator().manual_seed(1))
    assert x.shape == (N, K) and set(x.unique().tolist()) <= {-1.0, 1.0}
    # a lane axis on bx alone shares the precision: lane by lane the same
    bxs = rng.randn(2, N, K)
    rx, vx = port.compute_forward_posterior(_t(ax), _t(bxs))
    for i in range(2):
        r_i, v_i = port.compute_forward_posterior(_t(ax), _t(bxs[i]))
        assert_close(rx[i], r_i, 1e-12)
        assert_close(vx[i], v_i, 1e-12)
    with pytest.raises(ValueError, match="K x K precision"):
        port.compute_forward_posterior(_t(1.5), _t(bx))


def test_committee_binary_prior_denoiser_ep_raises_on_both_sides():
    """The EP engine passes one precision, the prior takes a K x K one: the
    denoiser x -> + noise -> y raises in the JAX package and in the port
    alike (its one exact step, a = I / var, is held above)."""
    import tramp_tpu as jtt
    import tramp_tpu_torch as tt
    from tramp_tpu.channels import GaussianChannel as JGaussianChannel
    from tramp_tpu_torch.channels import GaussianChannel
    from tramp_tpu_torch.parallel import EPSolver
    N, K = 12, 3
    y = np.random.RandomState(5).randn(N, K)
    ref = (jpriors.CommitteeBinaryPrior(N=N, K=K, p_pos=0.4) @ jtt.V(id="x")
           @ JGaussianChannel(var=0.1) @ jtt.O(id="y")).to_model()
    ref = ref.to_observed({"y": jnp.asarray(y)})
    with pytest.raises(ValueError):
        jtt.ExpectationPropagation(ref).iterate(max_iter=2)
    port = (priors.CommitteeBinaryPrior(N=N, K=K, p_pos=0.4, device="cpu",
                                        dtype=F64) @ tt.V(id="x")
            @ GaussianChannel(var=0.1) @ tt.O(id="y")).to_model()
    port = port.to_observed({"y": _t(y)})
    with pytest.raises(ValueError):
        EPSolver(port, max_iter=2).solve(port)


@pytest.mark.parametrize("name", list(PRIORS) + ["L1"])
def test_prior_rebuilt_from_the_jax_fields(name):
    """convert.factor_from_description gives the same prior: the mixture's
    (K,) arrays arrive as buffers, the numbers as numbers."""
    if name == "L1":
        ref = jpriors.MAP_L1NormPrior(size=10, gamma=0.6)
    else:
        ref = _pair(name, size=10)[1]
    port = convert.factor_from_description(describe_factor(ref),
                                           device="cpu", dtype=F64)
    if name == "mixture":
        assert set(port._buffers) == {"probs", "means", "vars"}
    rng = np.random.RandomState(8)
    bx, ax = rng.randn(10), 0.9
    for got, want in zip(port.compute_forward_posterior(_t(ax), _t(bx)),
                         ref.compute_forward_posterior(ax, jnp.asarray(bx))):
        assert_close(got, want, 1e-10)
