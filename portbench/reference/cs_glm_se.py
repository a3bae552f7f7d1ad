"""Plain reference of the compressed-sensing GLM's State Evolution (SE).

Model (Tree-AMP, Baker et al., JMLR 24(57) 2023, examples/glm): x ~ (1 -
rho) delta + rho N(0, 1), z = F x with F of Marchenko-Pastur spectrum at
ratio alpha, y = z + N(0, var). SE tracks one precision per directed edge
of the chain prior -> x -> F -> z -> output, all 0 at the start (the
initial backward precision a0 = 0 on x). One iteration sweeps forward, then
backward, with each factor's new precision a_new = clip(1 / v - a, AMIN,
AMAX), v its SE average and a the precision coming in on that edge:

- the prior, towards x, with ax coming in: v = E[v_post(ax, bx)], bx ~
  (1 - rho) N(0, ax) + rho N(0, ax + ax^2), where the posterior of the
  Gauss-Bernoulli prior under the Gaussian field (ax, bx) has a = ax + 1,
  slab probability s = sigmoid(b^2 / (2 a) + log(2 pi / a) / 2 - eta),
  eta = log(2 pi) / 2 - log(rho / (1 - rho)), and v_post = s / a + s (1 -
  s) (b / a)^2;
- the Marchenko-Pastur channel in closed form in alpha, with az coming in
  from x and ax from z: gamma = ax / az, n_eff = Phi(gamma) / (4 gamma),
  Phi(gamma) = (sqrt(gamma z+ + 1) - sqrt(gamma z- + 1))^2, z+- = (1 +-
  sqrt(alpha))^2; towards z v = n_eff / (alpha ax) (1 / az while ax is 0),
  towards x v = (1 - n_eff) / az (1 / az while ax is 0);
- the Gaussian output, towards z: a = 1 / var.

The sweep runs the engine's order: the prior, F forward, the output, F
backward (a variable passes its other edge's precision on). After each
sweep, x's and z's posterior variances 1 / (sum of their two incoming
precisions) are compared with the last sweep's: a point stops when the
largest |dv| falls below tol from the second sweep on, when the largest dv
rises above 0.2 after the fifth (its last state is kept: the rollback of
Tree-AMP's EarlyStopping(wait_increase=5, max_increase=0.2)), when a sweep
is not finite (its last state is kept), or after max_iter sweeps. Each point
runs to its own stop and is frozen there; only the live points are swept,
which is what freezing them leaves.

The prior's average is a fixed-node rule, where upstream Tree-AMP calls
scipy's adaptive quad over m +- 10 s: the range m +- 10 s in standard units
is cut at four break points around the spike-slab layer, at +-b* +- w with
b* = sqrt(2 a (eta + log(a / 2 pi) / 2)) (0 where negative) and w = 10 a /
max(b*, 1), clipped into the range; each of the five segments takes 8
equal panels of 16 Gauss-Legendre nodes with the Gaussian density folded
into the weights. This is the program's rule, written out again; it
departs from upstream by its error, which ``solve(..., rule=(panels,
order))`` with many more nodes measures: at most 4.4e-5 of the average
where b* > 0, 3.4e-3 where b* = 0 leaves the slab's narrow layer between
the nodes (ax = 316, rho = 0.95), and a median 4e-16 over the fixed points
of the phase grid (tests/test_torch_se_grid_reference.py). Everything else
is closed form. torch and numpy only, in the precision asked (float64 for
the check, float32 for its control), on the CPU unless told otherwise.
"""
import math

import numpy as np
import torch

# the precisions' clip of Tree-AMP (a in [AMIN, AMAX]) and its floor of a
# variance before it is inverted
AMIN, AMAX, VMIN = 1e-11, 1e11, 1e-20
#: the rule: the range in standard deviations, panels per segment, nodes
#: per panel
RANGE, PANELS, ORDER = 10.0, 8, 16
#: EarlyStopping's rollback: a rise of v above MAX_INCREASE after
#: WAIT_INCREASE sweeps
MAX_INCREASE, WAIT_INCREASE = 0.2, 5


def panel_rule(panels, order, dtype, device):
    """Nodes t in [0, 1] and weights: ``panels`` equal panels of ``order``
    Gauss-Legendre nodes each."""
    u, w = np.polynomial.legendre.leggauss(order)
    half = 0.5 / panels
    t = (np.arange(panels)[:, None] / panels + half * (u + 1.0)).ravel()
    wt = np.tile(half * w, panels)
    return (torch.as_tensor(t, dtype=dtype, device=device),
            torch.as_tensor(wt, dtype=dtype, device=device))


def gaussian_average(m, s, breaks, f, rule):
    """E[f(X)], X ~ N(m, s^2), over m +- RANGE s, the range cut at
    ``breaks`` (P, K) into segments of ``rule``'s panels; m, s (P, 1). f
    takes the nodes (P, nodes) and gives values of that shape."""
    t, wt = rule
    z = torch.clamp((breaks - m) / s, -RANGE, RANGE)
    ends = torch.full_like(z[:, :1], RANGE)
    edges = torch.sort(torch.cat([-ends, z, ends], 1), 1)[0]
    lo = edges[:, :-1, None]
    h = (edges[:, 1:] - edges[:, :-1])[..., None]
    nodes = lo + t * h
    weights = h * wt * torch.exp(-0.5 * nodes**2) / math.sqrt(2.0 * math.pi)
    return (weights.flatten(1) * f(m + s * nodes.flatten(1))).sum(1,
                                                                   True)


def prior_variance(ax, rho, rule):
    """The prior's SE average E[v_post(ax, bx)] for cavity precisions ax
    and sparsities rho, both (P, 1)."""
    a = ax + 1.0
    eta = 0.5 * math.log(2.0 * math.pi) - torch.log(rho / (1.0 - rho))

    def v_post(bx):
        s = torch.sigmoid(0.5 * bx**2 / a + 0.5 * torch.log(2.0 * math.pi / a)
                          - eta)
        return s / a + s * (1.0 - s) * (bx / a) ** 2

    b_star = torch.sqrt(torch.clamp(
        2.0 * a * (eta + 0.5 * torch.log(a / (2.0 * math.pi))), min=0.0))
    w = 10.0 * a / torch.clamp(b_star, min=1.0)
    breaks = torch.cat([-b_star - w, -b_star + w, b_star - w, b_star + w], 1)
    spike = gaussian_average(torch.zeros_like(ax), torch.sqrt(ax), breaks,
                             v_post, rule)
    slab = gaussian_average(torch.zeros_like(ax), torch.sqrt(ax + ax**2),
                            breaks, v_post, rule)
    return (1.0 - rho) * spike + rho * slab


def new_precision(v, a):
    "Tree-AMP's update: 1 / v - a, v floored at VMIN, clipped."
    return torch.clamp(1.0 / torch.clamp(v, min=VMIN) - a, AMIN, AMAX)


def n_eff(alpha, az, ax):
    "Phi(gamma) / (4 gamma), gamma = ax / az, for ax > 0."
    gamma = ax / az
    root = torch.sqrt(alpha)
    phi = (torch.sqrt(gamma * (1.0 + root) ** 2 + 1.0)
           - torch.sqrt(gamma * (1.0 - root) ** 2 + 1.0)) ** 2
    return phi / (4.0 * gamma)


def sweep(state, alpha, rho, var, rule):
    """One forward and backward sweep of the points' states: dicts of (P,
    1) precisions px (prior to x), fz (F to z), bx (F to x), bz (output to
    z)."""
    px = new_precision(prior_variance(state["bx"], rho, rule), state["bx"])
    az, ax = px, state["bz"]
    free = ax == 0
    safe = torch.where(free, torch.ones_like(ax), ax)
    ne = n_eff(alpha, az, safe)
    v_z = torch.where(free, 1.0 / az, ne / (alpha * safe))
    fz = new_precision(v_z, ax)
    bz = torch.full_like(ax, 1.0 / var)
    ne = n_eff(alpha, az, bz)
    bx = new_precision((1.0 - ne) / az, az)
    return {"px": px, "fz": fz, "bx": bx, "bz": bz}


def variances(state):
    "x's and z's posterior variances, (P, 2)."
    return torch.cat([1.0 / (state["px"] + state["bx"]),
                      1.0 / (state["fz"] + state["bz"])], 1)


def solve(config, alphas, rhos, tol, max_iter, dtype=torch.float64,
          device="cpu", rule=(PANELS, ORDER)):
    """SE of the points (alphas[i], rhos[i]) of the configuration
    (``output_var``, the prior's ``prior_mean`` 0 and ``prior_var`` 1),
    each to its own stop; ``rule`` (panels, order) of the prior's average.
    Returns (x's posterior variance (P,), the sweeps each point ran (P,),
    the points stopped by the |dv| rule (P,))."""
    if config["prior_mean"] != 0.0 or config["prior_var"] != 1.0:
        raise ValueError("the reference's prior is N(0, 1) in its slab")
    kw = dict(dtype=dtype, device=device)
    alpha = torch.as_tensor(np.asarray(alphas, float), **kw)[:, None]
    rho = torch.as_tensor(np.asarray(rhos, float), **kw)[:, None]
    rule = panel_rule(*rule, dtype, device)
    P = alpha.shape[0]
    state = {k: torch.zeros((P, 1), **kw) for k in ("px", "fz", "bx", "bz")}
    old = variances(state)
    n_iter = torch.zeros(P, dtype=torch.int64, device=device)
    conv = torch.zeros(P, dtype=torch.bool, device=device)
    live = torch.arange(P, device=device)
    for i in range(max_iter):
        if not len(live):
            break
        before = {k: v[live] for k, v in state.items()}
        after = sweep(before, alpha[live], rho[live], config["output_var"],
                      rule)
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
    return 1.0 / (state["px"] + state["bx"])[:, 0], n_iter, conv
