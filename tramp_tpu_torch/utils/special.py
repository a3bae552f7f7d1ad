"""Special functions of the truncated-normal moments, on ``torch.special``.

Counterpart of the default path of tramp_tpu/utils/special.py. The JAX
package's Chebyshev "kernel mode" forms exist only because Pallas on a TPU
cannot lower erf; the CUDA kernel (tramp_tpu_torch/csrc/pl_posterior.cu)
calls CUDA's own erfcx/erfc/erf instead, so they have no counterpart here.
"""
import torch

SQRT2 = 1.4142135623730951
SQRT_PI = 1.7724538509055159

# |x| below which exp(x^2)*erfc(x) is computed directly without overflow:
# float64 exp overflows at x ~ 26.6, float32 exp(x^2) already at x ~ 9.4
# (tramp_tpu/utils/special.py:28-40).
_ERFCX_DIRECT_MAX_F64 = 25.0
_ERFCX_DIRECT_MAX_F32 = 9.0


def erf(x):
    return torch.special.erf(x)


def norm_cdf(x):
    "Standard normal cdf Phi(x). Reference tramp/utils/misc.py:55-57."
    return torch.special.ndtr(x)


def erfcx(x):
    """Scaled complementary error function exp(x**2) * erfc(x), the same
    formula as tramp_tpu/utils/special.py:143-167: direct product for
    |x| <= dmax (dtype-aware), 5-term asymptotic series beyond, and
    2 exp(x^2) - erfcx(-x) for x < 0, which overflows to +inf for x << 0
    exactly as scipy does."""
    ax = torch.abs(x)
    dmax = (_ERFCX_DIRECT_MAX_F64 if torch.finfo(x.dtype).bits >= 64
            else _ERFCX_DIRECT_MAX_F32)
    axc = torch.clamp(ax, max=dmax)
    direct = torch.exp(axc * axc) * torch.special.erfc(axc)
    axa = torch.clamp(ax, min=dmax)
    z = 1.0 / (2.0 * axa * axa)
    poly = 1.0 + z * (-1.0 + z * (3.0 + z * (-15.0 + z * (105.0 + z * -945.0))))
    asym = poly / (axa * SQRT_PI)
    pos = torch.where(ax <= dmax, direct, asym)
    neg = 2.0 * torch.exp(torch.square(x)) - pos
    return torch.where(x >= 0, pos, neg)


def log_Phi_erfcx(x):
    """log Phi(x) through ``erfcx`` (tramp_tpu/utils/special.py:205-228).

    x <= 0: Phi(x) = 0.5 erfcx(-x/sqrt2) e^{-x^2/2}
    x >  0: Phi(x) = 1 - Phi(-x), via log1p (cancellation-free).
    Inputs are clamped to +-1e15 in u = x/sqrt2, so log Phi(-inf) saturates
    at -5e29 instead of -inf."""
    u = torch.clamp(x / SQRT2, -1e15, 1e15)
    lower = torch.log(0.5 * erfcx(-u)) - u * u
    upper = torch.log1p(-0.5 * erfcx(u) * torch.exp(-u * u))
    return torch.where(x <= 0, lower, upper)
