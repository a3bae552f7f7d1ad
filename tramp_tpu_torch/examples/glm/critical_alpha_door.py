"""Phase boundaries of the symmetric-door GLM via SE bisection.

Counterpart of examples/glm/critical_alpha_door.py (reference analog:
tramp/experiments/critical_alpha.py driven by
examples/glm/data/door_critical_lines.py: a0=0.1, p_pos=0.51, width grid).
Finds, for the width-1.5 door, the alpha above which the weakly informed
SE leaves the random (uninformative) fixed point ("random" criterion,
reference value 0.4621) and the alpha where it reaches perfect recovery
("perfect" criterion, reference value 2.2428), and the whole "perfect"
critical line over the prior bias p_pos. The JAX script runs one
bisection per criterion and one batched bisection for the line; here all
five searches are the lanes of one batched bisection (one batched SE solve
per level, a criterion per lane): the same alphas, in a third of the
solves. SE runs in float64.

Run: python -m tramp_tpu_torch.examples.glm.critical_alpha_door
[--device cpu]
"""

from tramp_tpu_torch import glm_state_evolution
from tramp_tpu_torch.experiments import (
    find_critical_alpha, find_critical_alpha_batched)
from tramp_tpu_torch.examples import _cli

#: the reference CSV's critical alphas of the width-1.5 door at p_pos 0.51
REFERENCE = (("random", 0.46214599609375), ("perfect", 2.24278564453125))
P_POS = [0.51, 0.6, 0.7, 0.8]
MODEL = dict(prior_type="binary", output_type="door", output_width=1.5)
SEARCH = dict(id="x", a0=0.1, alpha_min=0.1, alpha_max=3.0,
              model_builder=glm_state_evolution, **MODEL)


def critical_alpha(criterion, device, alpha_tol=1e-3):
    "The critical alpha of one criterion at p_pos = 0.51."
    return find_critical_alpha(mse_criterion=criterion, alpha_tol=alpha_tol,
                               prior_p_pos=0.51, device=device, **SEARCH)


def critical_alphas(p_pos, device, alpha_tol=1e-3):
    """The "random" critical alpha at p_pos = 0.51 and the "perfect" one at
    each of ``p_pos``, as the lanes of one batched bisection with a
    criterion per lane: every level is one SE solve of all lanes (p_pos is
    a per-lane hyperparameter of BinaryPrior). The lanes start from the
    same bracket, so they halve it on the schedule of ``critical_alpha``,
    and each lane's alpha is that of its own sequential search. Returns
    (the "random" alpha, the "perfect" line over ``p_pos``)."""
    alphas = find_critical_alpha_batched(
        mse_criterion=["random"] + ["perfect"] * len(p_pos),
        alpha_tol=alpha_tol, grid_kwargs={"prior_p_pos": [0.51, *p_pos]},
        device=device, **SEARCH)
    return float(alphas[0]), [float(a) for a in alphas[1:]]


def main(argv=None):
    args = _cli.parser(__doc__).parse_args(argv)
    device = _cli.device(args)
    random, line = critical_alphas(P_POS, device)
    # P_POS starts at the script's 0.51
    found = {"random": random, "perfect": line[0], "line": line}
    for criterion, ref in REFERENCE:
        print(f"critical alpha (door width=1.5, {criterion}): "
              f"{found[criterion]:.4f}  (reference CSV: {ref:.4f})")
    for p, a in zip(P_POS, line):
        print(f"  p_pos={p:.2f}: alpha_c={a:.4f}")
    return found


if __name__ == "__main__":
    main()
