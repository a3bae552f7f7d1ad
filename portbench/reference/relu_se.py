"""Plain reference of the relu GLM's State Evolution (SE).

Model (Tree-AMP, Baker et al., JMLR 24(57) 2023, examples/glm): x ~ (1 -
rho) delta + rho N(0, 1), z = F x with F of Marchenko-Pastur spectrum at
ratio alpha, a = relu(z), y = a + N(0, var). SE tracks one precision per
directed edge of the chain prior -> x -> F -> z -> relu -> a -> output, all
0 at the start (the engine's default initial condition). One iteration
sweeps forward, then backward, each factor's new precision a_new = clip(1 /
v - a, AMIN, AMAX), v its SE average and a the precision coming in on that
edge (a variable passes its other edge's precision on):

- the prior, towards x, and F both ways: ``reference/cs_glm_se.py``'s
  prior average and Marchenko-Pastur closed form;
- the relu channel, with az coming in from z and ax from a, and tau =
  E[z^2] = rho: towards a, v = E[vx(bz, bx)], towards z, v = E[vz(bz, bx)],
  (bz, bx) over the channel's beliefs measure (below), and vx, vz the
  variances of the posterior of (z, x = relu(z)) under the fields (az, bz)
  on z and (ax, bx) on x. That posterior is the mixture of the two regions'
  truncated Gaussians (upstream channels/linear_region.py:82-103,
  channels/activation/piecewise_linear_channel.py:27-58): on z >= 0, x = z,
  precision a1 = az + ax and field b1 = bz + bx; on z < 0, x = 0, a0 = az,
  b0 = bz. Region k has mass Z_k = sqrt(2 pi / a_k) exp(b_k^2 / (2 a_k))
  P_k, P_k the probability of its half-line under N(b_k / a_k, 1 / a_k),
  and the truncated Gaussian's mean and variance; the mixture weighs them
  by Z_k / (Z_0 + Z_1);
- the Gaussian output, towards a: a = 1 / var.

The sweep runs the engine's order: the prior, F forward, the relu channel
forward, the output, the relu channel backward, F backward. After each
sweep, the posterior variances of x, z and a, 1 / (the sum of their two
incoming precisions), are compared with the last sweep's: a point stops
when the largest |dv| falls below tol from the second sweep on, when the
largest dv rises above 0.2 after the fifth (its last state is kept: the
rollback of Tree-AMP's EarlyStopping(wait_increase=5, max_increase=0.2)),
when a sweep is not finite (its last state is kept), or after max_iter
sweeps. Each point runs to its own stop and is frozen there; only the live
points are swept.

The channel's beliefs measure, E over (bz, bx) of f, is the sum over the
two regions of a 2-D Gaussian average of P_k(bz, bx) f(bz, bx): on z >= 0
(bz, bx) ~ N(0, [[az u, ax u], [ax u, ax (ax tau + 1)]]), u = max(az tau -
1, 0), each diagonal entry plus 1e-12, taken along its Cholesky axes; on z
< 0 bz ~ N(0, az u) and bx ~ N(0, ax), independent. Each axis takes 10
equal panels of 10 Gauss-Legendre nodes over +-10 standard deviations with
the Gaussian density folded into the weights: 100 x 100 nodes a region,
20,000 a measure. This is the program's node rule, written out again;
upstream Tree-AMP runs scipy's ``dblquad`` instead. ``solve(...,
rule=(panels, order))`` takes a finer rule, which measures the departure
(tests/test_torch_relu_se_grid.py).

torch and numpy only, in the precision asked (float64 for the check,
float32 for its control), on the device asked.
"""
import math

import numpy as np
import torch

from .cs_glm_se import (
    MAX_INCREASE, PANELS, ORDER, WAIT_INCREASE, n_eff, new_precision,
    panel_rule, prior_variance,
)

#: the relu channel's rule: the range in standard deviations, panels per
#: axis, Gauss-Legendre nodes per panel
RELU_RANGE, RELU_PANELS, RELU_ORDER = 10.0, 10, 10
#: the jitter on the diagonal of the z >= 0 region's covariance
JITTER = 1e-12


def axis_rule(panels, order, dtype, device):
    """Nodes and weights of E[f(U)], U ~ N(0, 1), over +-RELU_RANGE:
    ``panels`` equal panels of ``order`` Gauss-Legendre nodes each, the
    density folded into the weights."""
    t, wt = panel_rule(panels, order, dtype, device)
    u = RELU_RANGE * (2.0 * t - 1.0)
    w = 2.0 * RELU_RANGE * wt * torch.exp(-0.5 * u**2) / math.sqrt(
        2.0 * math.pi)
    return u, w


def grid_rule(panels, order, dtype, device):
    """The product rule of ``axis_rule`` flattened: (u1, u2, w), u1 the
    slow axis."""
    u, w = axis_rule(panels, order, dtype, device)
    n = u.shape[0]
    return (u.repeat_interleave(n), u.repeat(n),
            (w[:, None] * w[None, :]).reshape(-1))


def _log_phi(t):
    "log of the standard normal density."
    return -0.5 * t**2 - 0.5 * math.log(2.0 * math.pi)


def _half_line(a, b, sign):
    """log Z, mean and variance of N(z | b / a, 1 / a) on z >= 0 (sign +1)
    or on z < 0 (sign -1)."""
    s = torch.rsqrt(a)
    t = sign * b * s
    log_p = torch.special.log_ndtr(t)
    lam = torch.exp(_log_phi(t) - log_p)
    log_z = 0.5 * torch.log(2.0 * math.pi / a) + 0.5 * b**2 / a + log_p
    mean = b / a + sign * s * lam
    var = (1.0 - lam * (lam + t)) / a
    return log_z, mean, var


def relu_posterior_variances(az, bz, ax, bx):
    """(vx, vz): the variances of x = relu(z) and of z under the posterior
    of the relu channel with fields (az, bz) on z and (ax, bx) on x."""
    log_z1, r1, v1 = _half_line(az + ax, bz + bx, 1.0)
    log_z0, r0, v0 = _half_line(az, bz, -1.0)
    p1 = torch.sigmoid(log_z1 - log_z0)
    p0 = 1.0 - p1
    vx = p1 * v1 + p1 * p0 * r1**2
    vz = p0 * v0 + p1 * v1 + p0 * p1 * (r1 - r0) ** 2
    return vx, vz


def relu_errors(az, ax, tau, rule):
    """(forward error E[vx], backward error E[vz]) of the relu channel
    over its beliefs measure, for precisions az, ax and tau, all (P, 1)."""
    u1, u2, w = rule
    u = torch.clamp(az * tau - 1.0, min=0.0)
    # z >= 0: the Cholesky axes of the covariance
    c00 = az * u + JITTER
    c10 = ax * u
    c11 = ax * (ax * tau + 1.0) + JITTER
    l00 = torch.sqrt(c00)
    l10 = c10 / l00
    l11 = torch.sqrt(c11 - l10 * l10)
    bz1 = l00 * u1
    bx1 = l10 * u1 + l11 * u2
    # z < 0: independent axes
    bz0 = torch.sqrt(az * u) * u1
    bx0 = torch.sqrt(ax) * u2
    bz = torch.cat([bz1, bz0], 1)
    bx = torch.cat([bx1, bx0], 1)
    # each region's probability of its half-line at its own nodes
    p_pos = torch.special.ndtr((bz1 + bx1) * torch.rsqrt(az + ax))
    p_neg = torch.special.ndtr(-bz0 * torch.rsqrt(az))
    weights = torch.cat([w * p_pos, w * p_neg], 1)
    vx, vz = relu_posterior_variances(az, bz, ax, bx)
    return (weights * vx).sum(1, True), (weights * vz).sum(1, True)


def sweep(state, alpha, rho, var, rules):
    """One forward and backward sweep of the points' states: dicts of (P,
    1) precisions px (prior to x), fz (F to z), fa (relu to a), ba (output
    to a), bz (relu to z), bx (F to x). ``rules``: (the prior's rule, the
    relu channel's grid rule)."""
    prior_rule, relu_rule = rules
    px = new_precision(prior_variance(state["bx"], rho, prior_rule),
                       state["bx"])
    # F forward, the precision coming in from z: 1 / az while it is 0
    ax = state["bz"]
    free = ax == 0
    safe = torch.where(free, torch.ones_like(ax), ax)
    v_z = torch.where(free, 1.0 / px, n_eff(alpha, px, safe) / (alpha * safe))
    fz = new_precision(v_z, ax)
    # the relu channel forward, with the output's precision of the last
    # sweep coming in from a
    ba = state["ba"]
    v_a, _ = relu_errors(fz, ba, rho, relu_rule)
    fa = new_precision(v_a, ba)
    ba = torch.full_like(ba, 1.0 / var)
    _, v_zb = relu_errors(fz, ba, rho, relu_rule)
    bz = new_precision(v_zb, fz)
    bx = new_precision((1.0 - n_eff(alpha, px, bz)) / px, px)
    return {"px": px, "fz": fz, "fa": fa, "ba": ba, "bz": bz, "bx": bx}


def variances(state):
    "x's, z's and a's posterior variances, (P, 3)."
    return torch.cat([1.0 / (state["px"] + state["bx"]),
                      1.0 / (state["fz"] + state["bz"]),
                      1.0 / (state["fa"] + state["ba"])], 1)


def solve(config, alphas, rhos, tol, max_iter, dtype=torch.float64,
          device="cpu", rule=(RELU_PANELS, RELU_ORDER)):
    """SE of the points (alphas[i], rhos[i]) of the configuration
    (``output_var``, the prior's ``prior_mean`` 0 and ``prior_var`` 1),
    each to its own stop; ``rule`` (panels, order) of each axis of the relu
    channel's measure. Returns (the posterior variances of x, z and a (P,
    3), the sweeps each point ran (P,), the points stopped by the |dv| rule
    (P,))."""
    if config["prior_mean"] != 0.0 or config["prior_var"] != 1.0:
        raise ValueError("the reference's prior is N(0, 1) in its slab")
    kw = dict(dtype=dtype, device=device)
    alpha = torch.as_tensor(np.asarray(alphas, float), **kw)[:, None]
    rho = torch.as_tensor(np.asarray(rhos, float), **kw)[:, None]
    rules = (panel_rule(PANELS, ORDER, dtype, device),
             tuple(r[None, :] for r in grid_rule(*rule, dtype, device)))
    P = alpha.shape[0]
    state = {k: torch.zeros((P, 1), **kw)
             for k in ("px", "fz", "fa", "ba", "bz", "bx")}
    old = variances(state)
    n_iter = torch.zeros(P, dtype=torch.int64, device=device)
    conv = torch.zeros(P, dtype=torch.bool, device=device)
    live = torch.arange(P, device=device)
    for i in range(max_iter):
        if not len(live):
            break
        before = {k: v[live] for k, v in state.items()}
        after = sweep(before, alpha[live], rho[live], config["output_var"],
                      rules)
        ok = torch.stack([torch.isfinite(v[:, 0]) for v in after.values()]
                         ).all(0)
        after = {k: torch.where(ok[:, None], after[k], before[k])
                 for k in after}
        new = variances(after)
        dv = new - old[live]
        stop = dv.abs().amax(1) < tol if i > 0 else torch.zeros_like(ok)
        back = (dv.amax(1) > MAX_INCREASE if i > WAIT_INCREASE
                else torch.zeros_like(ok))
        for k in state:
            state[k][live] = torch.where(back[:, None], before[k], after[k])
        old[live] = new
        n_iter[live] = i + 1
        conv[live] = stop
        live = live[~(stop | back | ~ok)]
    return variances(state), n_iter, conv
