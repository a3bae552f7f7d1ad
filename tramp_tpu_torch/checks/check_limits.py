"""Limit-consistency checks: the Bayes-optimal limit of the RS potential
must reproduce the BO potential, and the factor-graph potential's
Bayesian-network limit must match the direct BN quantities.
Counterpart of tramp_tpu/checks/check_limits.py (reference
tramp/checks/check_limits.py:9-180). Evaluated on ``device`` in float64
(None: that of the factor, else the first card)."""
import numpy as np

from .check_gradients import _dataframe, _device, _t


def check_prior_BO_limit(prior, ax_values=None, tx0_hat=0.3, device=None):
    """At the Nishimori point (m_hat = q_hat = ax - tx0_hat, teacher ==
    student) the RS potential equals the BO potential."""
    device = _device(device, prior)
    ax_values = ax_values if ax_values is not None else np.linspace(
        0.5, 2.5, 6)
    t0 = _t(tx0_hat, device)
    records = []
    for ax in ax_values:
        ax = float(ax)
        a = _t(ax, device)
        m_hat = a - t0
        A_BO = float(prior.compute_potential_BO(a, t0))
        A_RS = float(prior.compute_potential_RS(a, m_hat, m_hat, prior, t0))
        records.append(dict(ax=ax, A_BO=A_BO, A_RS=A_RS,
                            err=abs(A_BO - A_RS)))
    return _dataframe(records)


def check_likelihood_BO_limit(likelihood, az_values=None, tz0_hat=0.3,
                              device=None):
    device = _device(device, likelihood)
    az_values = az_values if az_values is not None else np.linspace(
        0.5, 2.5, 6)
    t0 = _t(tz0_hat, device)
    records = []
    for az in az_values:
        az = float(az)
        a = _t(az, device)
        m_hat = a - t0
        A_BO = float(likelihood.compute_potential_BO(a, t0))
        A_RS = float(likelihood.compute_potential_RS(
            a, m_hat, m_hat, likelihood, t0))
        records.append(dict(az=az, A_BO=A_BO, A_RS=A_RS,
                            err=abs(A_BO - A_RS)))
    return _dataframe(records)


def check_prior_BN_limit(prior, mx_hat_values=None, device=None):
    """tx0_hat -> 0 limit of the factor-graph (BO) potential must match the
    Bayesian-network quantities. Reference check_limits.py:54-73."""
    device = _device(device, prior)
    mx_hat_values = (mx_hat_values if mx_hat_values is not None
                     else np.linspace(1.0, 3.0, 10))
    records = []
    for mx_hat in mx_hat_values:
        mx_hat = float(mx_hat)
        # tx0_hat -> 0: a tiny value (exact 0 makes the FG measure
        # improper; the reference evaluates at tx0_hat=0 via its own limits)
        eps = _t(1e-9, device)
        m = _t(mx_hat, device)
        A_FG = float(prior.compute_potential_BO(ax=m + eps, tx0_hat=eps))
        vx_FG = float(prior.compute_forward_v_BO(ax=m + eps, tx0_hat=eps))
        A_BN = float(prior.compute_free_energy(ax=m))
        vx_BN = float(prior.compute_forward_error(ax=m))
        records.append(dict(
            mx_hat=mx_hat, A_FG=A_FG, A_BN=A_BN, vx_FG=vx_FG, vx_BN=vx_BN,
            A_err=abs(A_FG - A_BN), v_err=abs(vx_FG - vx_BN)))
    return _dataframe(records)


def check_likelihood_BN_limit(likelihood, mz_hat_values=None, tz0_hat=1.0,
                              device=None):
    """FG potential of a likelihood at (az = m_hat + t0, tau_z = 1/t0) must
    match the BN free energy / error. Reference check_limits.py:141-162."""
    device = _device(device, likelihood)
    mz_hat_values = (mz_hat_values if mz_hat_values is not None
                     else np.linspace(1.0, 3.0, 10))
    records = []
    t0 = _t(tz0_hat, device)
    tau_z = 1.0 / t0
    for mz_hat in mz_hat_values:
        mz_hat = float(mz_hat)
        az = _t(mz_hat, device) + t0
        A_FG = float(likelihood.compute_potential_BO(az=az, tz0_hat=t0))
        vz_FG = float(likelihood.compute_backward_v_BO(az=az, tz0_hat=t0))
        A_BN = float(likelihood.compute_free_energy(az=az, tau_z=tau_z))
        vz_BN = float(likelihood.compute_backward_error(az=az, tau_z=tau_z))
        records.append(dict(
            mz_hat=mz_hat, A_FG=A_FG, A_BN=A_BN, vz_FG=vz_FG, vz_BN=vz_BN,
            A_err=abs(A_FG - A_BN), v_err=abs(vz_FG - vz_BN)))
    return _dataframe(records)


def _plot_limit(df, x, pairs, title):
    import matplotlib.pyplot as plt
    fig, axs = plt.subplots(1, len(pairs), figsize=(4 * len(pairs), 4),
                            squeeze=False)
    for ax_, (a, b) in zip(axs[0], pairs):
        ax_.plot(df[x], df[a], "-", label=a)
        ax_.plot(df[x], df[b], "--", label=b)
        ax_.set(xlabel=x)
        ax_.legend()
    fig.suptitle(title)
    fig.tight_layout(rect=[0, 0.03, 1, 0.92])
    return fig


def plot_prior_BO_limit(prior, **kw):
    return _plot_limit(check_prior_BO_limit(prior, **kw), "ax",
                       [("A_BO", "A_RS")], repr(prior))


def plot_likelihood_BO_limit(likelihood, **kw):
    return _plot_limit(check_likelihood_BO_limit(likelihood, **kw), "az",
                       [("A_BO", "A_RS")], repr(likelihood))


def plot_prior_BN_limit(prior, **kw):
    return _plot_limit(check_prior_BN_limit(prior, **kw), "mx_hat",
                       [("A_BN", "A_FG"), ("vx_BN", "vx_FG")], repr(prior))


def plot_likelihood_BN_limit(likelihood, **kw):
    return _plot_limit(check_likelihood_BN_limit(likelihood, **kw),
                       "mz_hat", [("A_BN", "A_FG"), ("vz_BN", "vz_FG")],
                       repr(likelihood))
