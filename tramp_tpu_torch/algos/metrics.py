"""Metrics. Counterpart of tramp_tpu/algos/metrics.py; each returns a Python
float."""
import math

import torch


def _pair(x_true, x_pred):
    x_pred = torch.as_tensor(x_pred)
    return torch.as_tensor(x_true, device=x_pred.device,
                           dtype=x_pred.dtype), x_pred


def mean_squared_error(x_true, x_pred):
    x_true, x_pred = _pair(x_true, x_pred)
    return float(torch.mean((x_true - x_pred) ** 2))


def sign_symmetric_mse(x_true, x_pred):
    "MSE up to a global sign."
    x_true, x_pred = _pair(x_true, x_pred)
    mse_pos = torch.mean((x_true - x_pred) ** 2)
    mse_neg = torch.mean((x_true + x_pred) ** 2)
    return float(torch.minimum(mse_pos, mse_neg))


def phase_symmetric_mse(x_true, x_pred):
    """MSE up to a global phase (100-angle scan, reference l:19-26), on the
    packed re/im planes: ``x[0]`` real part, ``x[1]`` imaginary part."""
    x_true, xp = _pair(x_true, x_pred)
    phis = torch.linspace(0, 2 * math.pi, 100, device=xp.device,
                          dtype=xp.dtype)
    c, s = torch.cos(phis)[:, None], torch.sin(phis)[:, None]
    # e^{i phi} (re + i im): re' = c re - s im ; im' = s re + c im
    packed = torch.stack([c * xp[0][None] - s * xp[1][None],
                          s * xp[0][None] + c * xp[1][None]], dim=1)
    mses = torch.mean((x_true[None] - packed) ** 2, dim=(1, 2))
    return float(torch.min(mses))


def overlap(x_true, x_pred):
    x_true, x_pred = _pair(x_true, x_pred)
    return float(torch.mean(x_true * x_pred))


METRICS = {
    "sign_mse": sign_symmetric_mse,
    "phase_mse": phase_symmetric_mse,
    "mse": mean_squared_error,
    "overlap": overlap,
}
