"""Plain reference of the two-layer relu net: ML-VAMP, the EP fixed point
of the chain prior -> x -> W -> z -> relu -> a -> Gaussian likelihood.

Model: x ~ (1 - rho) delta + rho N(0, 1) (N entries), z = W x (M entries),
a = max(z, 0), y = a + N(0, var). Each interface i (x, z, a) holds a
forward message (fa_i, fb_i) from the factor before it and a backward
message (ba_i, bb_i) from the factor after it: an isotropic precision per
lane and a vector. The likelihood's message is the constant (1/var,
y/var). A sweep (Fletcher, Rangan, Schniter 2018; the EP updates of
Tree-AMP, JMLR 24(57) 2023) updates, in order, the forward messages of the
prior, W and the relu, then the backward messages of the relu and W; each
new message is moment matching against the posterior of its factor,

  a_new = clip(1 / <v> - a_in, AMIN, AMAX),  b_new = r (a_in + a_new) - b_in,

damped as damping * old + (1 - damping) * new, from all messages 0. The
posteriors of each factor:

- prior: the Gauss-Bernoulli denoiser of (ba_x, bb_x);
- W = U diag(s) V^T, input messages (az, bz) on x and (ax, bx) on z:
  m = (V^T bz + s U^T bx) / (az + ax s^2); the posterior mean of z is
  U diag(s) m, its variance (1/M) sum s^2 / (az + ax s^2) (with ax = 0:
  (1/M) sum s^2 / az); the posterior mean of x is bz / az + V (m - V^T bz
  / az), its variance (1/N) (sum 1 / (az + ax s^2) + (N - M) / az);
- relu: z ~ exp(-az z^2 / 2 + bz z), a = max(z, 0) ~ exp(-ax a^2 / 2 +
  bx a): the mixture of the half-line z >= 0 (precision az + ax, linear
  term bz + bx, a = z) and z < 0 (az, bz, a = 0), each a truncated
  Gaussian, weighted by its partition function.

The stop rule: the largest over interfaces of the relative change of the
posterior mean (fb + bb) / (fa + ba), as a root mean square, below tol,
at a step after the first.
"""
import math

import torch

from .plain import (
    AMAX, AMIN, follow, gauss_bernoulli, lane_mean, posteriors, products,
    svd,
)

SQRT_2_OVER_PI = math.sqrt(2.0 / math.pi)


def _half_line(m, sd, upper):
    """A Gaussian of mean m and deviation sd truncated to z > 0 (``upper``
    False: z >= 0 kept) or z < 0 (``upper`` True): (mean, variance, log of
    the kept mass). With the standardised bound c = -m / sd, the ratio of
    the density to the mass at the bound is sqrt(2 / pi) / erfcx(+-c /
    sqrt 2), which stays finite far in the tails."""
    c = -m / sd
    sign = -1.0 if upper else 1.0
    u = sign * c / math.sqrt(2.0)
    lam = SQRT_2_OVER_PI / torch.special.erfcx(u)
    mean = m + sign * sd * lam
    var = sd * sd * (1.0 + sign * c * lam - lam * lam)
    log_mass = torch.log(0.5 * torch.special.erfcx(u)) - u * u
    return mean, var, log_mass


def relu_posterior(az, bz, ax, bx):
    """The relu factor's posterior: (rz, <vz>, ra, <va>), means elementwise,
    variances averaged over each lane."""
    a_pos, b_pos = az + ax, bz + bx
    m_pos, sd_pos = b_pos / a_pos, torch.rsqrt(a_pos)
    m_neg, sd_neg = bz / az, torch.rsqrt(az)
    mean_pos, var_pos, mass_pos = _half_line(m_pos, sd_pos, upper=False)
    mean_neg, var_neg, mass_neg = _half_line(m_neg, sd_neg, upper=True)
    log_z_pos = 0.5 * b_pos * m_pos - 0.5 * torch.log(a_pos) + mass_pos
    log_z_neg = 0.5 * bz * m_neg - 0.5 * torch.log(az) + mass_neg
    w = torch.sigmoid(log_z_pos - log_z_neg)
    rz = w * mean_pos + (1.0 - w) * mean_neg
    vz = (w * (var_pos + mean_pos**2) + (1.0 - w) * (var_neg + mean_neg**2)
          - rz**2)
    ra = w * mean_pos
    va = w * (var_pos + mean_pos**2) - ra**2
    return rz, lane_mean(vz), ra, lane_mean(va)


def solve(config, W, ys, tol, max_iter, damping, dtype=torch.float64,
          tf32=False):
    """ML-VAMP on the lanes of ``ys`` (B, M) under the one operator ``W``
    (M, N). Returns ({"x", "z", "a": {"r", "v"}} of each lane at its stop,
    the stop sweep per lane, converged per lane)."""
    rho, var = config["rho"], config["noise_var"]
    with products(tf32):
        U, s, V = svd(W, dtype)
        y = ys.to(dtype)
        M, N = W.shape
        B = y.shape[0]
        s2 = s * s
        pin_a = torch.full((B, 1), 1.0 / var, dtype=dtype, device=y.device)
        pin_b = y / var

        def new(r, v, a, b):
            a_new = torch.clamp(1.0 / v - a, AMIN, AMAX)
            return a_new, r * (a + a_new) - b

        def damped(old, fresh):
            return tuple(damping * o + (1.0 - damping) * f
                         for o, f in zip(old, fresh))

        def linear_x(az, bz, ax, bx):
            "The x-side posterior of W: (mean, <variance>)."
            tz = bz @ V
            m = (tz + s * (bx @ U)) / (az + ax * s2)
            r = bz / az + (m - tz / az) @ V.T
            az = torch.clamp(az, min=AMIN)
            v = ((1.0 / (az + ax * s2)).sum(-1, keepdim=True)
                 + (N - M) / az) / N
            return r, v

        def linear_z(az, bz, ax, bx):
            "The z-side posterior of W: (mean, <variance>)."
            m = ((bz @ V) + s * (bx @ U)) / (az + ax * s2)
            r = (s * m) @ U.T
            v = (s2 / (az + ax * s2)).sum(-1, keepdim=True) / M
            return r, v

        def step(msgs):
            (fa_x, fb_x, ba_x, bb_x, fa_z, fb_z, ba_z, bb_z, fa_a,
             fb_a) = msgs
            # forward: prior, W, relu
            r, v = gauss_bernoulli(ba_x, bb_x, rho)
            fa_x, fb_x = damped((fa_x, fb_x),
                                new(r, lane_mean(v), ba_x, bb_x))
            r, v = linear_z(fa_x, fb_x, ba_z, bb_z)
            fa_z, fb_z = damped((fa_z, fb_z), new(r, v, ba_z, bb_z))
            _, _, r, v = relu_posterior(fa_z, fb_z, pin_a, pin_b)
            fa_a, fb_a = damped((fa_a, fb_a), new(r, v, pin_a, pin_b))
            # backward: relu, W
            r, v, _, _ = relu_posterior(fa_z, fb_z, pin_a, pin_b)
            ba_z, bb_z = damped((ba_z, bb_z), new(r, v, fa_z, fb_z))
            r, v = linear_x(fa_x, fb_x, ba_z, bb_z)
            ba_x, bb_x = damped((ba_x, bb_x), new(r, v, fa_x, fb_x))
            msgs = (fa_x, fb_x, ba_x, bb_x, fa_z, fb_z, ba_z, bb_z, fa_a,
                    fb_a)
            return msgs, means(msgs)

        def means(msgs):
            (fa_x, fb_x, ba_x, bb_x, fa_z, fb_z, ba_z, bb_z, fa_a,
             fb_a) = msgs
            return ((fb_x + bb_x) / (fa_x + ba_x),
                    (fb_z + bb_z) / (fa_z + ba_z),
                    (fb_a + pin_b) / (fa_a + pin_a))

        def delta(new_r, old_r):
            def rms(x):
                return torch.sqrt((x * x).mean(-1))
            return torch.stack([rms(n - o) / rms(n)
                                for n, o in zip(new_r, old_r)]).amax(0)

        def readout(msgs):
            (fa_x, fb_x, ba_x, bb_x, fa_z, fb_z, ba_z, bb_z, fa_a,
             fb_a) = msgs
            out = {}
            for vid, a, b in (("x", fa_x + ba_x, fb_x + bb_x),
                              ("z", fa_z + ba_z, fb_z + bb_z),
                              ("a", fa_a + pin_a, fb_a + pin_b)):
                out[f"{vid}.r"] = b / a
                out[f"{vid}.v"] = (1.0 / a).flatten()
            return out

        kw = dict(dtype=dtype, device=y.device)
        zero = torch.zeros(B, 1, **kw)
        start = (zero, torch.zeros(B, N, **kw), zero, torch.zeros(B, N, **kw),
                 zero, torch.zeros(B, M, **kw), zero, torch.zeros(B, M, **kw),
                 zero, torch.zeros(B, M, **kw))
        kept, stop, conv = follow(step, readout, start, tol, max_iter, delta)
    return posteriors(kept), stop, conv
