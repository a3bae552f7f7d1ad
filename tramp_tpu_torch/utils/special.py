"""Special functions of the truncated-normal moments, on ``torch.special``.

Counterpart of the default path of tramp_tpu/utils/special.py. The JAX
package's Chebyshev "kernel mode" forms exist only because Pallas on a TPU
cannot lower erf; the CUDA kernel (tramp_tpu_torch/csrc/pl_posterior.cu)
calls CUDA's own erfcx/erfc/erf instead, so they have no counterpart here.

``erfcx``, ``log_Phi_erfcx`` and the derivative of the latter carry their
analytic derivatives as ``torch.autograd.Function``s, the JAX package's
custom JVPs (tramp_tpu/utils/special.py:143-254): differentiating the
branchless primals leaks NaN (0 x inf from the branch not taken) at extreme
|x|, and the recursion y' = -y (x + y) of (log Phi)' keeps every order
finite. Each backward is written with these same functions, so it is itself
differentiable (the checks of tramp_tpu_torch.checks take second
derivatives). The Functions are entered only where autograd needs them;
their values are those of the plain compositions.
"""
import torch

SQRT2 = 1.4142135623730951
SQRT_PI = 1.7724538509055159
SQRT_2PI = 2.5066282746310002

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


def norm_pdf(x):
    "Standard normal pdf N(x). Reference tramp/utils/misc.py:60-62."
    return torch.exp(-0.5 * torch.square(x)) / SQRT_2PI


def log_Phi(x):
    "log Phi(x), stable for large |x|. Reference truncated_normal.py:22-30."
    return torch.special.log_ndtr(x)


def _tracked(x):
    "True where autograd records a call on ``x``."
    return torch.is_grad_enabled() and x.requires_grad


class _Erfcx(torch.autograd.Function):
    "d erfcx(x) = 2 x erfcx(x) - 2/sqrt(pi)."

    @staticmethod
    def forward(x):
        return _erfcx(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[0])

    @staticmethod
    def backward(ctx, grad):
        x, = ctx.saved_tensors
        return grad * (2.0 * x * erfcx(x) - 2.0 / SQRT_PI)


def erfcx(x):
    """Scaled complementary error function exp(x**2) * erfc(x), the same
    formula as tramp_tpu/utils/special.py:143-167: direct product for
    |x| <= dmax (dtype-aware), 5-term asymptotic series beyond, and
    2 exp(x^2) - erfcx(-x) for x < 0, which overflows to +inf for x << 0
    exactly as scipy does."""
    return _Erfcx.apply(x) if _tracked(x) else _erfcx(x)


def _erfcx(x):
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


class _LogPhiErfcx(torch.autograd.Function):
    "(log Phi)'(x) = _log_Phi_prime(x)."

    @staticmethod
    def forward(x):
        return _log_Phi_erfcx(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[0])

    @staticmethod
    def backward(ctx, grad):
        x, = ctx.saved_tensors
        return grad * _log_Phi_prime(x)


def log_Phi_erfcx(x):
    """log Phi(x) through ``erfcx`` (tramp_tpu/utils/special.py:205-228).

    x <= 0: Phi(x) = 0.5 erfcx(-x/sqrt2) e^{-x^2/2}
    x >  0: Phi(x) = 1 - Phi(-x), via log1p (cancellation-free).
    Inputs are clamped to +-1e15 in u = x/sqrt2, so log Phi(-inf) saturates
    at -5e29 instead of -inf."""
    return _LogPhiErfcx.apply(x) if _tracked(x) else _log_Phi_erfcx(x)


def _log_Phi_erfcx(x):
    u = torch.clamp(x / SQRT2, -1e15, 1e15)
    lower = torch.log(0.5 * _erfcx(-u)) - u * u
    upper = torch.log1p(-0.5 * _erfcx(u) * torch.exp(-u * u))
    return torch.where(x <= 0, lower, upper)


class _LogPhiPrime(torch.autograd.Function):
    """d/dx of (log Phi)'(x) = y is -y (x + y), at x clamped like the
    primal (tramp_tpu/utils/special.py:239-248): x = +-inf gives 0, not
    0 x inf."""

    @staticmethod
    def forward(x):
        u = torch.clamp(x / SQRT2, -1e15, 1e15)
        # erfcx(-u) -> inf for x >> 0 gives the correct 0 slope
        return 1.0 / (SQRT_2PI * 0.5 * _erfcx(-u))

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[0])

    @staticmethod
    def backward(ctx, grad):
        x, = ctx.saved_tensors
        y = _log_Phi_prime(x)
        xc = torch.clamp(x, -SQRT2 * 1e15, SQRT2 * 1e15)
        return grad * (-y * (xc + y))


def _log_Phi_prime(x):
    "(log Phi)'(x) = N(x)/Phi(x), the derivative of ``log_Phi_erfcx``."
    if _tracked(x):
        return _LogPhiPrime.apply(x)
    return _LogPhiPrime.forward(x)


def log_norm_cdf_prime(x):
    "(log Phi)'(x) = N(x)/Phi(x). Reference tramp/utils/misc.py:65-70."
    return 1.0 / (SQRT_2PI * 0.5 * erfcx(-x / SQRT2))


def phi_0(x):
    "phi(x) = x^2/2 + log Phi(x). Reference tramp/utils/misc.py:74-76."
    return torch.log(0.5 * erfcx(-x / SQRT2))


def phi_1(x):
    "phi'(x) = x + N/Phi. Reference tramp/utils/misc.py:79-81."
    return x + log_norm_cdf_prime(x)


def phi_2(x):
    "phi''(x) = 1 - N/Phi * (x + N/Phi). Reference tramp/utils/misc.py:84-86."
    y = log_norm_cdf_prime(x)
    return 1.0 - y * (x + y)
