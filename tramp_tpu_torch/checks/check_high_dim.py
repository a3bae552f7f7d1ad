"""High-dimensional concentration checks: finite-N instance averages must
concentrate onto the ensemble (state evolution) averages.
Counterpart of tramp_tpu/checks/check_high_dim.py (reference
tramp/checks/check_high_dim.py:9-260).

The draws come from a ``torch.Generator`` seeded with ``seed`` on
``device`` (None: that of the factor, else the first card), so they differ
from the JAX package's, whose RNG is another; the statistics they estimate
are the same. Instances are float64."""
import numpy as np
import torch

from .check_gradients import _dataframe, _device, _t


def _generator(device, seed):
    return torch.Generator(device=device).manual_seed(int(seed))


def _normal(shape, generator, device):
    return torch.randn(tuple(shape), generator=generator, device=device,
                       dtype=torch.float64)


def _mean_records(records):
    "Column means of a list of dicts of floats."
    return {k: float(np.mean([r[k] for r in records])) for k in records[0]}


def check_prior_concentration(prior_builder, N_values=(100, 1000, 10000),
                              ax=1.2, seed=0, device=None):
    """For increasing N, the instance average of the prior's scalar forward
    variance over b ~ beliefs_measure must approach compute_forward_error."""
    records = []
    for N in N_values:
        prior = prior_builder(N)
        dev = _device(device, prior)
        a = _t(ax, dev)
        ensemble_v = float(prior.compute_forward_error(a))
        # instance: sample x0 ~ prior, b = ax*x0 + sqrt(ax)*xi
        g = _generator(dev, seed)
        x0 = prior.sample(g).to(torch.float64)
        b = a * x0 + torch.sqrt(a) * _normal(x0.shape, g, dev)
        inst_v = float(torch.mean(prior.scalar_forward_variance(a, b)))
        records.append(dict(N=N, ensemble_v=ensemble_v, instance_v=inst_v,
                            err=abs(ensemble_v - inst_v)))
    return _dataframe(records)


def check_prior_BO_BN_high_dim(prior, n_samples=10, ax_values=None, seed=0,
                               device=None):
    """Instance averages (posterior variance/overlap/mse/logZ on sampled
    BO-BN observations) vs ensemble averages.
    Reference check_high_dim.py:9-48."""
    device = _device(device, prior)
    ax_values = ax_values if ax_values is not None else np.linspace(1, 3, 10)
    g = _generator(device, seed)
    records = []
    for ax in ax_values:
        ax = float(ax)
        a = _t(ax, device)
        inst = []
        for s in range(n_samples):
            x0 = prior.sample(g).to(torch.float64)
            bx = a * x0 + torch.sqrt(a) * _normal(x0.shape, g, device)
            rx, vx = prior.compute_forward_posterior(a, bx)
            inst.append(dict(
                vx=float(torch.mean(vx)),
                mx=float(torch.mean(x0 * rx)),
                qx=float(torch.mean(rx**2)),
                mse_x=float(torch.mean((x0 - rx) ** 2)),
                A=float(prior.compute_log_partition(a, bx) / x0.numel()),
            ))
        inst = _mean_records(inst)
        vx_avg = float(prior.compute_forward_error(a))
        A_avg = float(prior.compute_free_energy(a))
        mx_avg = float(prior.second_moment()) - vx_avg
        records.append(dict(
            ax=ax, vx=inst["vx"], mx=inst["mx"], qx=inst["qx"],
            mse_x=inst["mse_x"], A=inst["A"],
            vx_avg=vx_avg, mx_avg=mx_avg, A_avg=A_avg))
    return _dataframe(records)


def check_likelihood_BO_BN_high_dim(likelihood, n_samples=10, az_values=None,
                                    tau_z=1.0, seed=0, device=None):
    """Instance averages for a likelihood (z0 ~ N(0, tau_z), y = sample(z0),
    bz the BO message) vs ensemble averages.
    Reference check_high_dim.py:155-218."""
    device = _device(device, likelihood)
    az_values = (az_values if az_values is not None
                 else np.linspace(1.1, 3.0, 10))
    y_shape = tuple(likelihood.y.shape)
    g = _generator(device, seed)
    records = []
    for az in az_values:
        az = float(az)
        a = _t(az, device)
        inst = []
        for s in range(n_samples):
            z0 = np.sqrt(tau_z) * _normal(y_shape, g, device)
            y = likelihood.sample(g, z0)
            bz = a * z0 + torch.sqrt(a) * _normal(y_shape, g, device)
            rz, vz = likelihood.compute_backward_posterior(a, bz, y)
            inst.append(dict(
                vz=float(torch.mean(vz)),
                mz=float(torch.mean(z0 * rz)),
                mse_z=float(torch.mean((z0 - rz) ** 2)),
            ))
        inst = _mean_records(inst)
        vz_avg = float(likelihood.compute_backward_error(a, _t(tau_z,
                                                                device)))
        mz_avg = tau_z - vz_avg
        records.append(dict(az=az, vz=inst["vz"], mz=inst["mz"],
                            mse_z=inst["mse_z"], vz_avg=vz_avg,
                            mz_avg=mz_avg))
    return _dataframe(records)


def _plot_high_dim(df, x, pairs, title):
    import matplotlib.pyplot as plt
    fig, axs = plt.subplots(1, len(pairs), figsize=(4 * len(pairs), 4),
                            squeeze=False)
    for ax_, (inst, avg) in zip(axs[0], pairs):
        ax_.plot(df[x], df[inst], "x", label=f"{inst} (instance)")
        ax_.plot(df[x], df[avg], "-", label=f"{avg} (ensemble)")
        ax_.set(xlabel=x)
        ax_.legend()
    fig.suptitle(title)
    fig.tight_layout(rect=[0, 0.03, 1, 0.92])
    return fig


def plot_prior_BO_BN_high_dim(prior, n_samples=10, **kw):
    df = check_prior_BO_BN_high_dim(prior, n_samples, **kw)
    return _plot_high_dim(df, "ax", [("vx", "vx_avg"), ("mx", "mx_avg"),
                                     ("A", "A_avg")], repr(prior))


def plot_likelihood_BO_BN_high_dim(likelihood, n_samples=10, **kw):
    df = check_likelihood_BO_BN_high_dim(likelihood, n_samples, **kw)
    return _plot_high_dim(df, "az", [("vz", "vz_avg"), ("mz", "mz_avg")],
                          repr(likelihood))


def check_prior_RS_BN_high_dim(teacher, student, n_samples=10,
                               mx_hat_values=None, qx_hat=1.0, tx_hat=1.0,
                               seed=0, device=None):
    """RS instance-vs-ensemble: student posterior on teacher samples, with
    ax = qx_hat + tx_hat and tx0_hat -> 0 ensemble averages.
    Reference check_high_dim.py:72-122."""
    device = _device(device, student, teacher)
    mx_hat_values = (mx_hat_values if mx_hat_values is not None
                     else np.linspace(1.0, 3.0, 8))
    g = _generator(device, seed)
    records = []
    for mx_hat in mx_hat_values:
        mx_hat = float(mx_hat)
        ax = _t(qx_hat + tx_hat, device)
        inst = []
        for s in range(n_samples):
            x0 = teacher.sample(g).to(torch.float64)
            bx = mx_hat * x0 + np.sqrt(qx_hat) * _normal(x0.shape, g,
                                                         device)
            rx, vx = student.compute_forward_posterior(ax, bx)
            inst.append(dict(vx=float(torch.mean(vx)),
                             mx=float(torch.mean(x0 * rx)),
                             qx=float(torch.mean(rx**2))))
        inst = _mean_records(inst)
        vx_avg, mx_avg, qx_avg = student.compute_forward_vmq_RS(
            ax, _t(mx_hat, device), _t(qx_hat, device), teacher,
            _t(1e-9, device))
        records.append(dict(
            mx_hat=mx_hat, vx=inst["vx"], mx=inst["mx"], qx=inst["qx"],
            vx_avg=float(vx_avg), mx_avg=float(mx_avg),
            qx_avg=float(qx_avg)))
    return _dataframe(records)


def plot_prior_RS_BN_high_dim(teacher, student, n_samples=10, **kw):
    df = check_prior_RS_BN_high_dim(teacher, student, n_samples, **kw)
    return _plot_high_dim(
        df, "mx_hat", [("vx", "vx_avg"), ("mx", "mx_avg"), ("qx", "qx_avg")],
        f"teacher={teacher}\nstudent={student}")


def check_likelihood_RS_BN_high_dim(teacher, student, n_samples=10,
                                    mz_hat_values=None, qz_hat=1.0,
                                    tz0_hat=1.0, seed=0, device=None):
    """RS instance-vs-ensemble on the likelihood side.
    Reference check_high_dim.py:222-260."""
    device = _device(device, student, teacher)
    mz_hat_values = (mz_hat_values if mz_hat_values is not None
                     else np.linspace(1.0, 3.0, 8))
    y_shape = tuple(student.y.shape)
    tau_z = 1.0 / tz0_hat
    g = _generator(device, seed)
    records = []
    for mz_hat in mz_hat_values:
        mz_hat = float(mz_hat)
        az = _t(qz_hat, device)
        inst = []
        for s in range(n_samples):
            z0 = np.sqrt(tau_z) * _normal(y_shape, g, device)
            y = teacher.sample(g, z0)
            bz = mz_hat * z0 + np.sqrt(qz_hat) * _normal(y_shape, g,
                                                         device)
            rz, vz = student.compute_backward_posterior(az, bz, y)
            inst.append(dict(vz=float(torch.mean(vz)),
                             mz=float(torch.mean(z0 * rz)),
                             qz=float(torch.mean(rz**2))))
        inst = _mean_records(inst)
        vz_avg, mz_avg, qz_avg = student.compute_backward_vmq_RS(
            az, _t(mz_hat, device), _t(qz_hat, device), teacher,
            _t(tz0_hat, device))
        records.append(dict(
            mz_hat=mz_hat, vz=inst["vz"], mz=inst["mz"], qz=inst["qz"],
            vz_avg=float(vz_avg), mz_avg=float(mz_avg),
            qz_avg=float(qz_avg)))
    return _dataframe(records)


def plot_likelihood_RS_BN_high_dim(teacher, student, n_samples=10, **kw):
    df = check_likelihood_RS_BN_high_dim(teacher, student, n_samples, **kw)
    return _plot_high_dim(
        df, "mz_hat", [("vz", "vz_avg"), ("mz", "mz_avg"), ("qz", "qz_avg")],
        f"teacher={teacher}\nstudent={student}")
