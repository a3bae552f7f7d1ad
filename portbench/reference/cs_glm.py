"""Plain reference of the compressed-sensing GLM: VAMP in its SVD form.

Model: x ~ (1 - rho) delta + rho N(0, 1) (N entries), z = W x (M entries),
y = z + N(0, var). VAMP (Rangan, Schniter, Fletcher 2019, Algorithm 1 with
the LMMSE step diagonalised by W = U diag(s) V^T), from the uninformative
start r1 = 0, gamma1 = AMIN:

  x1 = g1(r1, gamma1),  <v1> = mean of its variance       (the denoiser)
  alpha1 = gamma1 <v1>,  r2 = (x1 - alpha1 r1) / (1 - alpha1),
  gamma2 = gamma1 (1 - alpha1) / alpha1
  d = (gamma2 V^T r2 + s U^T y / var) / (s^2 / var + gamma2)      (LMMSE)
  x2 = r2 + V (d - V^T r2)      (the N - M modes with s = 0 keep r2)
  alpha2 = gamma2 (sum 1 / (s^2 / var + gamma2) + (N - M) / gamma2) / N
  r1 = (x2 - alpha2 r2) / (1 - alpha2),  gamma1 = gamma2 (1 - alpha2) / alpha2

with the alphas clipped to [1e-11, 1 - 1e-11] and the gammas to
[AMIN, AMAX]. The loop stops at the first step after the first whose <v1>
moved by less than tol. The posteriors read out are x's (x1, <v1>) and z's
(U diag(s) d, mean of s^2 / (s^2 / var + gamma2)) at the last cavity.
"""
import torch

from .plain import (
    ALPHA_CLIP, AMAX, AMIN, follow, gauss_bernoulli, lane_mean, posteriors,
    products, svd,
)


def solve(config, W, ys, tol, max_iter, dtype=torch.float64, tf32=False):
    """VAMP on the lanes of ``ys`` (B, M) under the one operator ``W``
    (M, N). Returns ({"x": {"r", "v"}, "z": {...}} of each lane at its
    stop, the stop step per lane, converged per lane)."""
    rho, var = config["rho"], config["noise_var"]
    with products(tf32):
        U, s, V = svd(W, dtype)
        y = ys.to(dtype)
        M, N = W.shape
        p = s * (y @ U) / var
        s2d = s * s / var

        def lmmse_input(carry):
            r1, g1 = carry
            x1, v1 = gauss_bernoulli(g1, g1 * r1, rho)
            v1 = lane_mean(v1)
            a1 = torch.clamp(g1 * v1, ALPHA_CLIP, 1.0 - ALPHA_CLIP)
            r2 = (x1 - a1 * r1) / (1.0 - a1)
            g2 = torch.clamp(g1 * (1.0 - a1) / a1, AMIN, AMAX)
            return x1, v1, r2, g2

        def step(carry):
            _, v1, r2, g2 = lmmse_input(carry)
            t = r2 @ V
            den = s2d + g2
            d = (g2 * t + p) / den
            x2 = r2 + (d - t) @ V.T
            mean_inv = ((1.0 / den).sum(-1, keepdim=True)
                        + (N - M) / g2) / N
            a2 = torch.clamp(g2 * mean_inv, ALPHA_CLIP, 1.0 - ALPHA_CLIP)
            r1 = (x2 - a2 * r2) / (1.0 - a2)
            g1 = torch.clamp(g2 * (1.0 - a2) / a2, AMIN, AMAX)
            return (r1, g1), v1.flatten()

        def readout(carry):
            x1, v1, r2, g2 = lmmse_input(carry)
            den = s2d + g2
            d = (g2 * (r2 @ V) + p) / den
            return {"x.r": x1, "x.v": v1.flatten(),
                    "z.r": (s * d) @ U.T,
                    "z.v": (s * s / den).sum(-1) / M}

        B = y.shape[0]
        start = (torch.zeros(B, N, dtype=dtype, device=y.device),
                 torch.full((B, 1), AMIN, dtype=dtype, device=y.device))
        kept, stop, conv = follow(step, readout, start, tol, max_iter,
                                  lambda new, old: torch.abs(new - old))
    return posteriors(kept), stop, conv

