"""Numerically stable moments of the truncated normal distribution.

Counterpart of tramp_tpu/utils/truncated_normal.py, kept branchless: every
regime (close / neg / pos / other) is evaluated on sanitized in-regime
inputs and combined with ``torch.where``, so the plain version is one
elementwise chain on any device. Interval bounds ``zmin``/``zmax`` are
Python floats (possibly +-inf): the infinite cases are dispatched in
Python, like the reference's if/elif on the bounds
(tramp/utils/truncated_normal.py:239-247).
"""
import math

import torch

from .special import erf, erfcx, log_Phi_erfcx, norm_cdf, SQRT2, SQRT_PI

_CLOSE_THRESH = 1e-7
_INF = math.inf


def _switch(x, y):
    "Order so that |x| <= |y|. Reference truncated_normal.py:14-18."
    cond = torch.abs(x) > torch.abs(y)
    return torch.where(cond, y, x), torch.where(cond, x, y)


def _masks(x, y):
    close = torch.abs(x - y) <= _CLOSE_THRESH
    neg = (x < 0) & (y < 0) & ~close
    pos = (x > 0) & (y > 0) & ~close
    other = ~(close | neg | pos)
    return close, neg, pos, other


def _where4(masks, vals):
    close, neg, pos, other = masks
    v_close, v_neg, v_pos, v_other = vals
    out = torch.where(close, v_close, v_other)
    out = torch.where(neg, v_neg, out)
    out = torch.where(pos, v_pos, out)
    return out


def _sanitize(mask, x, y, x_def, y_def):
    "Clamp inputs to an in-regime default where the branch is not selected."
    return torch.where(mask, x, x_def), torch.where(mask, y, y_def)


def F0(x, y):
    "log|erf(y) - erf(x)| for finite x, y. Reference truncated_normal.py:66-91."
    x, y = _switch(x, y)
    masks = _masks(x, y)
    close, neg, pos, other = masks
    xc, yc = _sanitize(close, x, y, 0.0, 0.0)
    e = yc - xc
    e_safe = (torch.clamp(torch.abs(e), min=1e-300)
              * torch.where(e < 0, -1.0, 1.0))
    f_close = (
        -xc * e
        + (1.0 / 6.0) * (xc**2 - 2.0) * e**2
        # deliberate bug-for-bug compatibility: the e**4 factor of the
        # next Taylor term is missing in the reference too, kept so that
        # fixed points match the reference in the close regime
        - (1.0 / 180.0) * (xc**4 + 2.0 * xc**2 - 8.0)
        + torch.log(2.0 * torch.abs(e_safe) / SQRT_PI)
    ) - xc**2
    xn, yn = _sanitize(neg, x, y, -1.0, -2.0)
    Dn = torch.exp(xn**2 - yn**2)  # |x|<=|y| so <= 1
    f_neg = torch.log(torch.abs(Dn * erfcx(-yn) - erfcx(-xn))) - xn**2
    xp, yp = _sanitize(pos, x, y, 1.0, 2.0)
    Dp = torch.exp(xp**2 - yp**2)
    f_pos = torch.log(torch.abs(erfcx(xp) - Dp * erfcx(yp))) - xp**2
    xo, yo = _sanitize(other, x, y, -1.0, 1.0)
    f_other = torch.log(torch.abs(erf(yo) - erf(xo)))
    return _where4(masks, (f_close, f_neg, f_pos, f_other))


def F1(x, y):
    """(exp(-x^2) - exp(-y^2)) / (erf(y) - erf(x)) for finite x, y.
    Reference truncated_normal.py:94-147."""
    x, y = _switch(x, y)
    masks = _masks(x, y)
    close, neg, pos, other = masks
    xc, yc = _sanitize(close, x, y, 0.0, 0.0)
    e = yc - xc
    f_close = SQRT_PI * (
        xc
        + 0.5 * e
        - (1.0 / 6.0) * e**2
        - (1.0 / 12.0) * e**3
        + (1.0 / 90.0) * xc * (xc**2 + 1.0) * e**4
    )
    xn, yn = _sanitize(neg, x, y, -1.0, -2.0)
    Dn = torch.exp(xn**2 - yn**2)
    f_neg = (1.0 - Dn) / (Dn * erfcx(-yn) - erfcx(-xn))
    xp, yp = _sanitize(pos, x, y, 1.0, 2.0)
    Dp = torch.exp(xp**2 - yp**2)
    f_pos = (1.0 - Dp) / (erfcx(xp) - Dp * erfcx(yp))
    xo, yo = _sanitize(other, x, y, -1.0, 1.0)
    Do = torch.exp(xo**2 - yo**2)
    f_other = torch.exp(-xo**2) * (1.0 - Do) / (erf(yo) - erf(xo))
    return _where4(masks, (f_close, f_neg, f_pos, f_other))


def F2(x, y):
    """(x exp(-x^2) - y exp(-y^2)) / (erf(y) - erf(x)) for finite x, y.
    Reference truncated_normal.py:150-204."""
    x, y = _switch(x, y)
    masks = _masks(x, y)
    close, neg, pos, other = masks
    xc, yc = _sanitize(close, x, y, 0.0, 0.0)
    e = yc - xc
    f_close = SQRT_PI * (
        xc**2 - 0.5
        + xc * e
        - (1.0 / 3.0) * (xc**2 - 1.0) * e**2
        - (1.0 / 3.0) * xc * e**3
        + (1.0 / 90.0) * (2.0 * xc**4 + 3.0 * xc**2 - 8.0) * e**4
    )
    xn, yn = _sanitize(neg, x, y, -1.0, -2.0)
    Dn = torch.exp(xn**2 - yn**2)
    f_neg = (xn - Dn * yn) / (Dn * erfcx(-yn) - erfcx(-xn))
    xp, yp = _sanitize(pos, x, y, 1.0, 2.0)
    Dp = torch.exp(xp**2 - yp**2)
    f_pos = (xp - Dp * yp) / (erfcx(xp) - Dp * erfcx(yp))
    xo, yo = _sanitize(other, x, y, -1.0, 1.0)
    Do = torch.exp(xo**2 - yo**2)
    f_other = torch.exp(-xo**2) * (xo - Do * yo) / (erf(yo) - erf(xo))
    return _where4(masks, (f_close, f_neg, f_pos, f_other))


def F0_inf(x, sign):
    "F0(x, sign*inf). Reference truncated_normal.py:32-34."
    return torch.log(erfcx(sign * x)) - x**2


def F1_inf(x, sign):
    "F1(x, sign*inf). Reference truncated_normal.py:94-96."
    return sign / erfcx(sign * x)


def F2_inf(x, sign):
    "F2(x, sign*inf). Reference truncated_normal.py:150-152."
    return sign * x / erfcx(sign * x)


def G0(x, y):
    "log|Phi(y) - Phi(x)|. Reference truncated_normal.py:207-209."
    return math.log(0.5) + F0(x / SQRT2, y / SQRT2)


def G1(x, y):
    "[N(x) - N(y)] / [Phi(y) - Phi(x)]. Reference truncated_normal.py:212-214."
    return math.sqrt(2.0 / math.pi) * F1(x / SQRT2, y / SQRT2)


def G2(x, y):
    "[y N(y) - x N(x)] / [Phi(y) - Phi(x)]. Reference truncated_normal.py:217-219."
    return (2.0 / SQRT_PI) * F2(x / SQRT2, y / SQRT2)


def G0_inf(x, sign):
    "G0(x, sign*inf) = log Phi(-sign*x). Reference truncated_normal.py:222-225."
    return log_Phi_erfcx(-sign * x)


def G1_inf(x, sign):
    return math.sqrt(2.0 / math.pi) * F1_inf(x / SQRT2, sign)


def G2_inf(x, sign):
    return (2.0 / SQRT_PI) * F2_inf(x / SQRT2, sign)


def _check_bounds(zmin, zmax):
    if not (zmin < zmax):
        raise ValueError(f"need zmin < zmax, got [{zmin}, {zmax}]")


def _g(G, G_inf, r0, v0, zmin, zmax):
    "One of G0/G1/G2 at the standardized bounds, inf cases in Python."
    s0 = torch.sqrt(v0)
    if zmax == _INF and zmin == -_INF:
        return torch.zeros_like(r0 / s0)
    if zmax == _INF:
        return G_inf((zmin - r0) / s0, +1.0)
    if zmin == -_INF:
        return G_inf((zmax - r0) / s0, -1.0)
    return G((zmin - r0) / s0, (zmax - r0) / s0)


def truncated_normal_mean(r0, v0, zmin, zmax):
    """Mean of N(z | r0, v0) restricted to [zmin, zmax].
    Reference truncated_normal.py:234-247."""
    _check_bounds(zmin, zmax)
    return r0 + torch.sqrt(v0) * _g(G1, G1_inf, r0, v0, zmin, zmax)


def truncated_normal_var(r0, v0, zmin, zmax):
    """Variance of N(z | r0, v0) restricted to [zmin, zmax].
    Reference truncated_normal.py:250-266."""
    _check_bounds(zmin, zmax)
    g1 = _g(G1, G1_inf, r0, v0, zmin, zmax)
    g2 = _g(G2, G2_inf, r0, v0, zmin, zmax)
    return v0 * (1.0 + g2 - g1**2)


def truncated_normal_log_proba(r0, v0, zmin, zmax):
    """log P(z in [zmin, zmax]) under N(z | r0, v0).
    Reference truncated_normal.py:269-281."""
    _check_bounds(zmin, zmax)
    return _g(G0, G0_inf, r0, v0, zmin, zmax)


def truncated_normal_proba(r0, v0, zmin, zmax):
    """P(z in [zmin, zmax]) under N(z | r0, v0).
    Reference truncated_normal.py:284-291."""
    _check_bounds(zmin, zmax)
    s0 = torch.sqrt(v0)
    hi = 1.0 if zmax == _INF else norm_cdf((zmax - r0) / s0)
    lo = 0.0 if zmin == -_INF else norm_cdf((zmin - r0) / s0)
    return hi - lo


def truncated_normal_logZ(r0, v0, zmin, zmax):
    """Log partition of N(z | r0, v0) delta_[zmin, zmax](z).
    Reference truncated_normal.py:294-298."""
    g0 = truncated_normal_log_proba(r0, v0, zmin, zmax)
    return 0.5 * torch.log(2.0 * math.pi * v0) + 0.5 * r0**2 / v0 + g0
