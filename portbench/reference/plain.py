"""Plain pieces shared by the references: the SVD of an operator, the
Gauss-Bernoulli denoiser, and the loop that follows every lane to the
step where its stop rule fires.

Written from the published equations (VAMP: Rangan, Schniter, Fletcher,
IEEE Trans. Inf. Theory 65(10), 2019, Algorithm 1 in its SVD form;
ML-VAMP: Fletcher, Rangan, Schniter, ISIT 2018, and the EP factor updates of
Tree-AMP, Baker et al., JMLR 24(57), 2023), with torch and nothing of the
program under test. Every function takes the precision it computes in, so
the same code serves as the float64 reference and, with TF32 products on,
as the control.
"""
import contextlib
import math

import torch

# the precisions' clip of Tree-AMP (a in [AMIN, AMAX]) and VAMP's clip of
# the divergence-free weights (alpha in [ALPHA_CLIP, 1 - ALPHA_CLIP])
AMIN, AMAX = 1e-11, 1e11
ALPHA_CLIP = 1e-11


@contextlib.contextmanager
def products(tf32):
    """Float32 products in TF32 (the control) or in full float32 (the
    reference and the program's configuration), restored afterwards."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def svd(W, dtype):
    """Thin SVD of W (M, N), M <= N, through the eigendecomposition of the
    Gram matrix W W^T: (U (M, M), s (M,), V (N, M)) with W = U diag(s) V^T.
    The Gram matrix of an i.i.d. operator with M / N = alpha < 1 has its
    eigenvalues in [(1 - sqrt(alpha))^2, (1 + sqrt(alpha))^2] N-scaled, so
    squaring the condition number costs nothing here."""
    W = W.to(dtype)
    M, N = W.shape
    if M > N:
        raise ValueError(f"svd: W is {M} x {N}; the references take M <= N")
    s2, U = torch.linalg.eigh(W @ W.T)
    s = torch.sqrt(torch.clamp(s2, min=0.0))
    V = (W.T @ U) / s
    return U, s, V


def gauss_bernoulli(a, b, rho):
    """Posterior of x under (1 - rho) delta(x) + rho N(x | 0, 1) times
    exp(-a x^2 / 2 + b x), elementwise: (mean, variance). The slab's
    weight is sigmoid(logit(rho) - log(1 + a) / 2 + b^2 / (2 (1 + a)))."""
    a1 = a + 1.0
    m = b / a1
    weight = torch.sigmoid(math.log(rho / (1.0 - rho))
                           - 0.5 * torch.log(a1) + 0.5 * b * m)
    return weight * m, weight / a1 + weight * (1.0 - weight) * m * m


def lane_mean(v):
    "Mean over each lane's elements, kept as (B, 1)."
    return v.mean(-1, keepdim=True)


def posteriors(kept):
    "{'x.r': ..., 'x.v': ...} -> {'x': {'r': ..., 'v': ...}}."
    out = {}
    for key, value in kept.items():
        vid, field = key.split(".")
        out.setdefault(vid, {})[field] = value
    return out


def follow(step, readout, carry, tol, max_iter, delta):
    """Run ``step`` on every lane and keep each lane's readout at the step
    where its own stop rule fires.

    ``step(carry) -> (carry, stop quantity)``; ``delta(new, old)`` -> (B,)
    the lane's stop metric from two successive stop quantities; the rule
    fires at the first step k >= 2 whose delta is below ``tol`` (the first
    step has no predecessor to compare with); a lane that never fires is
    read at ``max_iter``. ``readout(carry)`` -> {name: (B, ...) tensor}.
    Returns (readouts, stop step per lane (int64), converged per lane
    (bool))."""
    B = carry[0].shape[0]
    stop = torch.full((B,), max_iter, dtype=torch.int64)
    conv = torch.zeros(B, dtype=torch.bool)
    kept = None
    old = None
    for k in range(1, max_iter + 1):
        carry, quantity = step(carry)
        if old is not None:
            fired = (delta(quantity, old).cpu() < tol) & ~conv
            stop = torch.where(fired, torch.tensor(k), stop)
            conv |= fired
        old = quantity
        hit = (stop == k).nonzero().flatten().tolist()
        if hit:
            values = readout(carry)
            if kept is None:
                kept = {name: torch.full_like(v, math.nan)
                        for name, v in values.items()}
            for name, v in values.items():
                kept[name][hit] = v[hit]
        if bool(conv.all()):
            break
    return kept, stop, conv
