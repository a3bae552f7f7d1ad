"""Gradient/conjugacy checkers: moments must be gradients of log-partitions.
Counterpart of tramp_tpu/checks/check_gradients.py.

The reference verifies these identities with finite differences
(tramp/checks/check_gradients.py); here ``torch.autograd`` gives exact
first and second derivatives (``create_graph=True``), so the checks are as
tight as the JAX package's ``jax.grad``. Finite-difference helpers are kept
for API parity. Every checker evaluates on ``device`` in float64 (None:
that of the factor, else the first card) and returns a pandas DataFrame
(pandas is imported by the checker), with a ``plot_*`` twin (matplotlib is
imported by the plot).
"""
import numpy as np
import torch

from ..config import default_device

EPSILON = 1e-3


def numerical_1st_derivative(x, f, epsilon=EPSILON):
    return (f(x + 0.5 * epsilon) - f(x - 0.5 * epsilon)) / epsilon


def numerical_2nd_derivative(x, f, epsilon=EPSILON):
    return (f(x + epsilon) - 2 * f(x) + f(x - epsilon)) / epsilon**2


def _device(device, *factors):
    """``device``, else that of the first factor's arrays or the one it
    was built with, else the first card."""
    if device is not None:
        return torch.device(device)
    for f in factors:
        found = next((b.device for b in f.buffers()), None) \
            or getattr(f, "device", None)
        if found is not None:
            return torch.device(found)
    return default_device()


def _t(x, device, grad=False):
    "A float64 scalar tensor of x on device."
    return torch.tensor(float(x), dtype=torch.float64, device=device,
                        requires_grad=grad)


def _grad(y, x, create_graph=False):
    "dy/dx, 0 where y does not depend on x."
    g, = torch.autograd.grad(y, x, create_graph=create_graph,
                             allow_unused=True)
    return torch.zeros_like(x) if g is None else g


def _d1_d2(A, x0, device):
    "(A'(x0), A''(x0)) as floats, A of a 0-d float64 tensor."
    x = _t(x0, device, grad=True)
    d1 = _grad(A(x), x, create_graph=True)
    d2 = _grad(d1, x) if d1.requires_grad else torch.zeros_like(x)
    return float(d1.detach()), float(d2)


def _d1(A, x0, device):
    x = _t(x0, device, grad=True)
    return float(_grad(A(x), x))


def _dataframe(records):
    import pandas as pd
    return pd.DataFrame(records)


def check_belief_grad_b(belief, device=None, **kwargs):
    """r = dA/db and v = d2A/db2 for a belief module, over a grid of b.
    Reference check_gradients.py:79-90."""
    from ..beliefs import exponential, mixture
    device = _device(device)
    kwargs = {k: (torch.as_tensor(v, dtype=torch.float64, device=device)
                  if isinstance(v, (float, int, list, tuple, np.ndarray))
                  else v)
              for k, v in kwargs.items()}
    b_values = np.linspace(-6, 6, 100)
    if belief is exponential:
        b_values = np.linspace(-6, -1, 100)
    records = []
    for b in b_values:
        b = float(b)
        if belief is mixture:
            def A(b_):
                return belief.A(b=b_ + kwargs["b0"], a=kwargs["a"],
                                eta=kwargs["eta"])
            bt = _t(b, device)
            r = belief.r(b=bt + kwargs["b0"], a=kwargs["a"],
                         eta=kwargs["eta"])
            v = belief.v(b=bt + kwargs["b0"], a=kwargs["a"],
                         eta=kwargs["eta"])
        else:
            def A(b_):
                return belief.A(b=b_, **kwargs)
            bt = _t(b, device)
            r = belief.r(b=bt, **kwargs)
            v = belief.v(b=bt, **kwargs)
        A1, A2 = _d1_d2(A, b, device)
        records.append(dict(b=b, r=float(torch.sum(r)),
                            v=float(torch.sum(v)), A1=A1, A2=A2))
    return _dataframe(records)


def plot_belief_grad_b(belief, **kwargs):
    import matplotlib.pyplot as plt
    df = check_belief_grad_b(belief, **kwargs)
    fig, axs = plt.subplots(1, 2, figsize=(8, 4))
    axs[0].plot(df["b"], df["r"], "-", label="r")
    axs[0].plot(df["b"], df["A1"], "--", label=r"$\partial_b A$")
    axs[0].legend()
    axs[1].plot(df["b"], df["v"], "-", label="v")
    axs[1].plot(df["b"], df["A2"], "--", label=r"$\partial_b^2 A$")
    axs[1].legend()
    fig.suptitle(belief.__name__)
    return fig


def check_prior_grad_EP(prior, ax=1.3, b_values=None, device=None):
    """EP conjugacy for a prior: r = dA/db, v = d2A/db2 at scalar level.
    Reference check_gradients.py:256-325."""
    device = _device(device, prior)
    b_values = b_values if b_values is not None else np.linspace(-4, 4, 50)
    ax_t = _t(ax, device)
    records = []
    for bx in b_values:
        bx = float(bx)

        def A(b):
            return torch.sum(prior.scalar_log_partition(ax_t, b))

        A1, A2 = _d1_d2(A, bx, device)
        b = _t(bx, device)
        r = float(torch.sum(prior.scalar_forward_mean(ax_t, b)))
        v = float(torch.sum(prior.scalar_forward_variance(ax_t, b)))
        records.append(dict(bx=bx, r=r, v=v, A1=A1, A2=A2,
                            r_err=abs(r - A1), v_err=abs(v - A2)))
    return _dataframe(records)


def check_prior_grad_BO(prior, mx_hat_values=None, tx0_hat=1.0,
                        device=None):
    """BO potential gradient: mx = 2 dA_BO/dm_hat with
    A_BO(m_hat) = potential_BO(ax=m_hat+t0_hat).
    Reference check_gradients.py:165-196."""
    device = _device(device, prior)
    mx_hat_values = (mx_hat_values if mx_hat_values is not None
                     else np.linspace(1.0, 3.0, 10))
    t0 = _t(tx0_hat, device)
    records = []
    for mx_hat in mx_hat_values:
        mx_hat = float(mx_hat)

        def A(m_hat):
            return prior.compute_potential_BO(ax=m_hat + t0, tx0_hat=t0)

        dm = _d1(A, mx_hat, device)
        vx = float(prior.compute_forward_v_BO(_t(mx_hat, device) + t0, t0))
        tx = float(prior.forward_second_moment_FG(t0))
        mx = tx - vx
        records.append(dict(mx_hat=mx_hat, mx=mx, vx=vx, tx=tx,
                            two_dA_dmhat=2 * dm, m_err=abs(mx - 2 * dm)))
    return _dataframe(records)


def check_prior_grad_BO_BN(prior, ax_values=None, device=None):
    """Bayesian-network limit: mx = 2 dA/dax, vx = 2 dI/dax.
    Reference check_gradients.py:199-229."""
    device = _device(device, prior)
    ax_values = ax_values if ax_values is not None else np.linspace(1, 3, 10)
    records = []
    for ax in ax_values:
        ax = float(ax)
        dA = _d1(prior.compute_free_energy, ax, device)
        dI = _d1(prior.compute_mutual_information, ax, device)
        mx = float(prior.compute_forward_overlap(_t(ax, device)))
        vx = float(prior.compute_forward_error(_t(ax, device)))
        records.append(dict(ax=ax, mx=mx, vx=vx, two_dA_dax=2 * dA,
                            two_dI_dax=2 * dI, m_err=abs(mx - 2 * dA),
                            v_err=abs(vx - 2 * dI)))
    return _dataframe(records)


def check_prior_grad_FG(prior, tx_hat_values=None, device=None):
    """Factor-graph potential: tau_x = -2 dA_FG/dt_hat.
    Reference check_gradients.py:232-258."""
    device = _device(device, prior)
    tx_hat_values = (tx_hat_values if tx_hat_values is not None
                     else np.linspace(1, 3, 10))
    records = []
    for tx_hat in tx_hat_values:
        tx_hat = float(tx_hat)
        dA = _d1(prior.prior_log_partition_FG, tx_hat, device)
        tx = float(prior.forward_second_moment_FG(_t(tx_hat, device)))
        records.append(dict(tx_hat=tx_hat, tx=tx, minus2_dA=-2 * dA,
                            t_err=abs(tx + 2 * dA)))
    return _dataframe(records)


def _rs_gradients(potential, m_hat0, q_hat0, device):
    "(dA/dm_hat, dA/dq_hat) of potential(m_hat, q_hat) as floats."
    m_hat = _t(m_hat0, device, grad=True)
    q_hat = _t(q_hat0, device, grad=True)
    A = potential(m_hat, q_hat)
    dm, dq = torch.autograd.grad(A, (m_hat, q_hat), allow_unused=True)
    dm = 0.0 if dm is None else float(dm)
    dq = 0.0 if dq is None else float(dq)
    return dm, dq


def check_prior_grad_RS(teacher, student, mx_hat=0.7, qx_hat=0.5,
                        tx0_hat=0.2, device=None):
    """RS gradients m = dA/dm_hat, q = -2 dA/dq_hat.
    Reference check_gradients.py:115-255 (finite differences -> autograd)."""
    device = _device(device, student, teacher)
    t0 = _t(tx0_hat, device)

    def A(m_hat, q_hat):
        ax = q_hat  # tx_hat = 0 convention
        return student.compute_potential_RS(ax, m_hat, q_hat, teacher, t0)

    dm, dq = _rs_gradients(A, mx_hat, qx_hat, device)
    q = _t(qx_hat, device)
    vx, mx, qx = student.compute_forward_vmq_RS(
        q, _t(mx_hat, device), q, teacher, t0)
    return _dataframe([dict(
        m=float(mx), dA_dmhat=dm, q=float(qx), minus2_dA_dqhat=-2 * dq,
        m_err=abs(float(mx) - dm), q_err=abs(float(qx) + 2 * dq))])


def check_likelihood_grad_EP(likelihood, az=1.5, b_values=None, y=0.7,
                             device=None):
    """EP conjugacy for a likelihood: r = dA/db, v = d2A/db2.
    Reference check_gradients.py:478-539."""
    device = _device(device, likelihood)
    b_values = b_values if b_values is not None else np.linspace(-4, 4, 50)
    az_t, y_t = _t(az, device), _t(y, device)
    records = []
    for bz in b_values:
        bz = float(bz)

        def A(b):
            return torch.sum(likelihood.scalar_log_partition(az_t, b, y_t))

        A1, A2 = _d1_d2(A, bz, device)
        b = _t(bz, device)
        r = float(torch.sum(likelihood.scalar_backward_mean(az_t, b, y_t)))
        v = float(torch.sum(
            likelihood.scalar_backward_variance(az_t, b, y_t)))
        records.append(dict(bz=bz, r=r, v=v, A1=A1, A2=A2,
                            r_err=abs(r - A1), v_err=abs(v - A2)))
    return _dataframe(records)


def check_likelihood_grad_BO(likelihood, mz_hat_values=None, tz0_hat=1.0,
                             device=None):
    """BO potential gradient for a likelihood: mz = 2 dA_BO/dm_hat.
    Reference check_gradients.py:408-435."""
    device = _device(device, likelihood)
    mz_hat_values = (mz_hat_values if mz_hat_values is not None
                     else np.linspace(1.0, 3.0, 10))
    t0 = _t(tz0_hat, device)
    records = []
    for mz_hat in mz_hat_values:
        mz_hat = float(mz_hat)

        def A(m_hat):
            return likelihood.compute_potential_BO(az=m_hat + t0,
                                                   tz0_hat=t0)

        dm = _d1(A, mz_hat, device)
        vz = float(likelihood.compute_backward_v_BO(
            _t(mz_hat, device) + t0, t0))
        tz = float(likelihood.backward_second_moment_FG(t0))
        mz = tz - vz
        records.append(dict(mz_hat=mz_hat, mz=mz, vz=vz, tz=tz,
                            two_dA_dmhat=2 * dm, m_err=abs(mz - 2 * dm)))
    return _dataframe(records)


def check_likelihood_grad_BO_BN(likelihood, az_values=None, tau_z=1.0,
                                device=None):
    """Bayesian-network limit for a likelihood: mz = 2 dA/daz.
    Reference check_gradients.py:438-470."""
    device = _device(device, likelihood)
    az_values = (az_values if az_values is not None
                 else np.linspace(1.1, 3.0, 10))
    tau = _t(tau_z, device)
    records = []
    for az in az_values:
        az = float(az)
        dA = _d1(lambda a: likelihood.compute_free_energy(a, tau), az,
                 device)
        mz = float(likelihood.compute_backward_overlap(_t(az, device), tau))
        records.append(dict(az=az, mz=mz, two_dA_daz=2 * dA,
                            m_err=abs(mz - 2 * dA)))
    return _dataframe(records)


def check_likelihood_grad_RS(teacher, student, mz_hat=1.2, qz_hat=0.8,
                             tz0_hat=1.0, device=None):
    """RS gradients for a likelihood: m = dA/dm_hat, q = -2 dA/dq_hat.
    Reference check_gradients.py:366-405."""
    device = _device(device, student, teacher)
    t0 = _t(tz0_hat, device)

    def A(m_hat, q_hat):
        az = q_hat
        return student.compute_potential_RS(az, m_hat, q_hat, teacher, t0)

    dm, dq = _rs_gradients(A, mz_hat, qz_hat, device)
    q = _t(qz_hat, device)
    vz, mz, qz = student.compute_backward_vmq_RS(
        q, _t(mz_hat, device), q, teacher, t0)
    return _dataframe([dict(
        m=float(mz), dA_dmhat=dm, q=float(qz), minus2_dA_dqhat=-2 * dq,
        m_err=abs(float(mz) - dm), q_err=abs(float(qz) + 2 * dq))])


def check_likelihood_grad_FG(likelihood, tz_hat_values=None, device=None):
    """Factor-graph potential of a likelihood: tau_z = -2 dA_FG/dt_hat.
    Reference check_gradients.py (likelihood FG section)."""
    device = _device(device, likelihood)
    tz_hat_values = (tz_hat_values if tz_hat_values is not None
                     else np.linspace(1, 3, 10))
    records = []
    for tz_hat in tz_hat_values:
        tz_hat = float(tz_hat)
        dA = _d1(likelihood.prior_log_partition_FG, tz_hat, device)
        tz = float(likelihood.backward_second_moment_FG(_t(tz_hat, device)))
        records.append(dict(tz_hat=tz_hat, tz=tz, minus2_dA=-2 * dA,
                            t_err=abs(tz + 2 * dA)))
    return _dataframe(records)
# -- plot twins (reference check_gradients.py plot_* functions) -----------

def _plot_pairs(df, x, pairs, title):
    import matplotlib.pyplot as plt
    fig, axs = plt.subplots(1, len(pairs), figsize=(4 * len(pairs), 4),
                            squeeze=False)
    for ax_, (solid, dashed, label) in zip(axs[0], pairs):
        ax_.plot(df[x], df[solid], "-", label=solid)
        ax_.plot(df[x], df[dashed], "--", label=label)
        ax_.set(xlabel=x)
        ax_.legend()
    fig.suptitle(title)
    fig.tight_layout(rect=[0, 0.03, 1, 0.92])
    return fig


def plot_prior_grad_EP(prior, **kw):
    df = check_prior_grad_EP(prior, **kw)
    return _plot_pairs(df, "bx", [("r", "A1", r"$\partial_b A$"),
                                  ("v", "A2", r"$\partial_b^2 A$")],
                       repr(prior))


def plot_prior_grad_BO(prior, **kw):
    df = check_prior_grad_BO(prior, **kw)
    return _plot_pairs(
        df, "mx_hat",
        [("mx", "two_dA_dmhat", r"$2\partial_{\hat m} A$")], repr(prior))


def plot_prior_grad_BO_BN(prior, **kw):
    df = check_prior_grad_BO_BN(prior, **kw)
    return _plot_pairs(
        df, "ax", [("mx", "two_dA_dax", r"$2\partial_{a} A$"),
                   ("vx", "two_dI_dax", r"$2\partial_{a} I$")], repr(prior))


def plot_prior_grad_FG(prior, **kw):
    df = check_prior_grad_FG(prior, **kw)
    return _plot_pairs(
        df, "tx_hat",
        [("tx", "minus2_dA", r"$-2\partial_{\hat\tau} A$")], repr(prior))


def plot_likelihood_grad_EP(likelihood, **kw):
    df = check_likelihood_grad_EP(likelihood, **kw)
    return _plot_pairs(df, "bz", [("r", "A1", r"$\partial_b A$"),
                                  ("v", "A2", r"$\partial_b^2 A$")],
                       repr(likelihood))


def plot_likelihood_grad_BO(likelihood, **kw):
    df = check_likelihood_grad_BO(likelihood, **kw)
    return _plot_pairs(
        df, "mz_hat",
        [("mz", "two_dA_dmhat", r"$2\partial_{\hat m} A$")],
        repr(likelihood))


def plot_likelihood_grad_BO_BN(likelihood, **kw):
    df = check_likelihood_grad_BO_BN(likelihood, **kw)
    return _plot_pairs(
        df, "az", [("mz", "two_dA_daz", r"$2\partial_{a} A$")],
        repr(likelihood))


def plot_likelihood_grad_FG(likelihood, **kw):
    df = check_likelihood_grad_FG(likelihood, **kw)
    return _plot_pairs(
        df, "tz_hat",
        [("tz", "minus2_dA", r"$-2\partial_{\hat\tau} A$")],
        repr(likelihood))


def plot_prior_grad_RS(teacher, student, **kw):
    import matplotlib.pyplot as plt
    df = check_prior_grad_RS(teacher, student, **kw)
    fig, ax_ = plt.subplots(figsize=(4, 4))
    ax_.bar(["m_err", "q_err"], [df["m_err"].iloc[0], df["q_err"].iloc[0]])
    ax_.set(title="RS gradient identity errors")
    return fig


def plot_likelihood_grad_RS(teacher, student, **kw):
    import matplotlib.pyplot as plt
    df = check_likelihood_grad_RS(teacher, student, **kw)
    fig, ax_ = plt.subplots(figsize=(4, 4))
    ax_.bar(["m_err", "q_err"], [df["m_err"].iloc[0], df["q_err"].iloc[0]])
    ax_.set(title="RS gradient identity errors")
    return fig


# the reference distinguishes scalar and diagonal (vectorized) EP checks
# (check_gradients.py:279-365); the torch kernels are the vectorized path, so
# both names exercise the same identities here.
check_prior_grad_EP_scalar = check_prior_grad_EP
check_prior_grad_EP_diagonal = check_prior_grad_EP
plot_prior_grad_EP_scalar = plot_prior_grad_EP
plot_prior_grad_EP_diagonal = plot_prior_grad_EP
check_likelihood_grad_EP_scalar = check_likelihood_grad_EP
check_likelihood_grad_EP_diagonal = check_likelihood_grad_EP
plot_likelihood_grad_EP_scalar = plot_likelihood_grad_EP
plot_likelihood_grad_EP_diagonal = plot_likelihood_grad_EP
