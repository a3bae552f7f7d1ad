"""tramp_tpu_torch.checks against tramp_tpu.checks, float64 on the CPU:
the counterparts of tests/test_checks.py (the upstream symbol-coverage test
aside), every check run in both packages on the same factors, and the
derivatives of the special functions that carry their own (the
``torch.autograd.Function``s of utils/special.py against ``jax.grad`` of
the JAX package's custom JVPs).

Tolerances: a check's value columns (moments, derivatives, potentials) at
rtol 1e-10 of JAX's with a floor of rtol times the column's largest
magnitude, except the BN limits taken at tx0_hat = 1e-9, whose potentials
cancel to 1e-7 relative (rtol 1e-6); its error columns under the bounds of
tests/test_checks.py. The high-dimensional checks draw from torch's RNG,
not JAX's: their ensemble columns are held at rtol 1e-10 and their instance
columns against JAX's within the sampling spread of these sizes (0.05,
as tests/test_checks.py:124-126 holds instance against ensemble). The
special functions' derivatives at rtol 1e-12, or 1e-5 where the second
derivative of log_norm_cdf_prime at x = -1e3 cancels; NaN and infinities
where JAX has them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tramp_tpu import beliefs as jbeliefs
from tramp_tpu import checks as jchecks
from tramp_tpu.likelihoods import SgnLikelihood as JSgnLikelihood
from tramp_tpu.priors import (
    BinaryPrior as JBinaryPrior, GaussBernoulliPrior as JGaussBernoulliPrior,
)
from tramp_tpu.utils import special as jspecial

from tramp_tpu_torch import beliefs, checks
from tramp_tpu_torch.likelihoods import SgnLikelihood
from tramp_tpu_torch.priors import BinaryPrior, GaussBernoulliPrior
from tramp_tpu_torch.utils import special

from torch_parity import assert_close

F64 = dict(device="cpu", dtype=torch.float64)


def _gb(rho, size=1):
    return GaussBernoulliPrior(size=size, rho=rho, **F64), \
        JGaussBernoulliPrior(size=size, rho=rho)


def _binary():
    return BinaryPrior(size=1, p_pos=0.6, **F64), \
        JBinaryPrior(size=1, p_pos=0.6)


def _sgn(y=(1.0,)):
    return SgnLikelihood(y=np.asarray(y), **F64), \
        JSgnLikelihood(y=jnp.asarray(y))


# case -> (function name, factors (port, jax), keywords, {error column:
# bound}); the bounds of tests/test_checks.py where it has the case
CASES = {
    "belief_grad_b": ("check_belief_grad_b", None,
                      dict(a=1.3, eta=0.4), {}),
    "prior_grad_EP": ("check_prior_grad_EP", lambda: [_gb(0.4)], {},
                      {"r_err": 1e-8, "v_err": 1e-7}),
    "prior_grad_RS": ("check_prior_grad_RS", lambda: [_binary()] * 2, {},
                      {"m_err": 1e-6, "q_err": 1e-5}),
    "prior_BO_limit": ("check_prior_BO_limit", lambda: [_gb(0.3)], {},
                       {"err": 1e-7}),
    "likelihood_grad_EP": ("check_likelihood_grad_EP",
                           lambda: [(SgnLikelihood(y=None),
                                     JSgnLikelihood(y=None))],
                           dict(y=1.0), {"r_err": 1e-7, "v_err": 1e-6}),
    "prior_grad_BO": ("check_prior_grad_BO", lambda: [_gb(0.4)], {},
                      {"m_err": 1e-6}),
    "prior_grad_BO_BN": ("check_prior_grad_BO_BN", lambda: [_binary()], {},
                         {"m_err": 1e-6, "v_err": 1e-6}),
    "prior_grad_FG": ("check_prior_grad_FG", lambda: [_gb(0.3)], {},
                      {"t_err": 1e-6}),
    "likelihood_grad_BO": ("check_likelihood_grad_BO", lambda: [_sgn()], {},
                           {"m_err": 1e-5}),
    "likelihood_grad_BO_BN": ("check_likelihood_grad_BO_BN",
                              lambda: [_sgn()], {}, {"m_err": 1e-5}),
    "likelihood_grad_RS": ("check_likelihood_grad_RS",
                           lambda: [_sgn()] * 2, {},
                           {"m_err": 1e-5, "q_err": 1e-5}),
    "likelihood_grad_FG": ("check_likelihood_grad_FG", lambda: [_sgn()], {},
                           {"t_err": 1e-5}),
    "prior_BN_limit": ("check_prior_BN_limit", lambda: [_gb(0.4)], {},
                       {"v_err": 1e-4}),
    "likelihood_BN_limit": ("check_likelihood_BN_limit", lambda: [_sgn()],
                            {}, {"v_err": 1e-4}),
    "likelihood_BO_limit": ("check_likelihood_BO_limit", lambda: [_sgn()],
                            {}, {"err": 1e-6}),
}
# limits evaluated at tx0_hat = 1e-9 cancel there
CASE_RTOL = {"prior_BN_limit": 1e-6}
# grids on which JAX's side is compared (its eager second derivatives take
# a fifth of a second a point); the port's bounds hold on the full grid
JAX_GRID = {"prior_grad_EP": dict(b_values=np.linspace(-4, 4, 50)[::7]),
            "likelihood_grad_EP": dict(b_values=np.linspace(-4, 4, 50)[::7]),
            "likelihood_grad_BO": dict(
                mz_hat_values=np.linspace(1.0, 3.0, 10)[::5])}


def test_all_names_of_the_jax_package():
    assert len(jchecks.__all__) == 49
    assert checks.__all__ == jchecks.__all__
    assert all(callable(getattr(checks, name)) for name in checks.__all__)


@pytest.mark.parametrize("case", list(CASES))
def test_check_against_jax(case):
    name, factors, kwargs, bounds = CASES[case]
    if factors is None:
        port_args, jax_args = (beliefs.sparse,), (jbeliefs.sparse,)
    else:
        pairs = factors()
        port_args = tuple(p for p, _ in pairs)
        jax_args = tuple(j for _, j in pairs)
    df = getattr(checks, name)(*port_args, device="cpu", **kwargs)
    for col, bound in bounds.items():
        assert df[col].max() < bound, (case, col, df[col].max())
    if case in JAX_GRID:
        kwargs = dict(kwargs, **JAX_GRID[case])
        df = getattr(checks, name)(*port_args, device="cpu", **kwargs)
    j_df = getattr(jchecks, name)(*jax_args, **kwargs)
    assert list(df.columns) == list(j_df.columns) and len(df) == len(j_df)
    rtol = CASE_RTOL.get(case, 1e-10)
    for col in df.columns:
        if col.endswith("err"):
            continue
        assert_close(df[col].to_numpy(), j_df[col].to_numpy(), rtol,
                     what=f"{case} {col}")
    if case == "belief_grad_b":
        # tests/test_checks.py:14-17
        assert np.allclose(df["r"], df["A1"], rtol=1e-8, atol=1e-10)
        assert np.allclose(df["v"], df["A2"], rtol=1e-6, atol=1e-9)


def _hold_instances(df, j_df, instance_cols, ensemble_cols):
    for col in ensemble_cols:
        assert_close(df[col].to_numpy(), j_df[col].to_numpy(), 1e-10,
                     what=col)
    for col in instance_cols:
        spread = np.abs(df[col].to_numpy() - j_df[col].to_numpy()).max()
        assert spread < 5e-2, (col, spread)


def test_check_prior_concentration():
    "tests/test_checks.py:51-56, and the ensemble value against JAX's."
    df = checks.check_prior_concentration(
        lambda N: GaussBernoulliPrior(size=N, rho=0.5, **F64),
        N_values=(100, 10000))
    assert df["err"].iloc[-1] < df["err"].iloc[0] + 1e-3
    assert df["err"].iloc[-1] < 0.01
    j_df = jchecks.check_prior_concentration(
        lambda N: JGaussBernoulliPrior(size=N, rho=0.5), N_values=(100,))
    assert_close(df["ensemble_v"].to_numpy()[:1],
                 j_df["ensemble_v"].to_numpy(), 1e-10)


def test_check_high_dim_bo_bn():
    "tests/test_checks.py:118-126, and against JAX's by their statistics."
    prior, j_prior = _gb(0.5, size=3000)
    df = checks.check_prior_BO_BN_high_dim(prior, n_samples=2,
                                           ax_values=[1.0, 2.0])
    assert np.max(np.abs(df["vx"] - df["vx_avg"])) < 5e-2
    assert np.max(np.abs(df["mx"] - df["mx_avg"])) < 5e-2
    j_df = jchecks.check_prior_BO_BN_high_dim(j_prior, n_samples=2,
                                              ax_values=[1.0, 2.0])
    _hold_instances(df, j_df, ("vx", "mx", "qx", "mse_x", "A"),
                    ("vx_avg", "mx_avg", "A_avg"))


def test_check_high_dim_rs_and_likelihoods():
    prior, j_prior = _gb(0.5, size=3000)
    lik, j_lik = _sgn(np.zeros(3000))
    pairs = (
        ("check_prior_RS_BN_high_dim", (prior, prior), (j_prior, j_prior),
         dict(mx_hat_values=[1.0, 2.0]), ("vx", "mx", "qx"),
         ("vx_avg", "mx_avg", "qx_avg")),
        ("check_likelihood_BO_BN_high_dim", (lik,), (j_lik,),
         dict(az_values=[1.5, 2.5]), ("vz", "mz", "mse_z"),
         ("vz_avg", "mz_avg")),
        ("check_likelihood_RS_BN_high_dim", (lik, lik), (j_lik, j_lik),
         dict(mz_hat_values=[1.5]), ("vz", "mz"),
         ("vz_avg", "mz_avg", "qz_avg")),
    )
    for name, args, j_args, kw, inst, ens in pairs:
        df = getattr(checks, name)(*args, n_samples=2, **kw)
        j_df = getattr(jchecks, name)(*j_args, n_samples=2, **kw)
        _hold_instances(df, j_df, inst, ens)


XS = [-1e3, -40.0, -5.0, 0.0, 5.0, 40.0, 1e3, np.inf, -np.inf]


@pytest.mark.parametrize("name", ["erfcx", "log_Phi_erfcx",
                                  "log_norm_cdf_prime"])
def test_special_function_derivatives_match_jax_grad(name):
    """First and second derivatives through autograd against jax.grad of
    the JAX functions, at extreme and infinite x: equal, and finite where
    JAX's are; values unchanged, and no Function where no grad is asked."""
    f, j_f = getattr(special, name), getattr(jspecial, name)
    j1 = np.array([float(jax.grad(j_f)(x)) for x in XS])
    j2 = np.array([float(jax.grad(jax.grad(j_f))(x)) for x in XS])
    x = torch.tensor(XS, dtype=torch.float64, requires_grad=True)
    y = f(x)
    d1, = torch.autograd.grad(y.sum(), x, create_graph=True)
    d2, = torch.autograd.grad(d1.sum(), x)
    for got, want, rtol in ((d1.detach(), j1, 1e-12), (d2, j2, 1e-5)):
        got = got.numpy()
        np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        fin = np.isfinite(want)
        np.testing.assert_array_equal(got[~fin & ~np.isnan(want)],
                                      want[~fin & ~np.isnan(want)])
        np.testing.assert_allclose(got[fin], want[fin], rtol=rtol,
                                   atol=1e-300)
    xs = x.detach()
    plain = f(xs)
    assert plain.grad_fn is None
    np.testing.assert_array_equal(plain.numpy(), y.detach().numpy())
    np.testing.assert_allclose(
        plain.numpy(), np.array([float(j_f(v)) for v in XS]), rtol=1e-13)
