"""Phase boundaries of the symmetric-door GLM via SE bisection.

Counterpart of examples/glm/critical_alpha_door.py (reference analog:
tramp/experiments/critical_alpha.py driven by
examples/glm/data/door_critical_lines.py: a0=0.1, p_pos=0.51, width grid).
Finds, for the width-1.5 door, the alpha above which the weakly informed
SE leaves the random (uninformative) fixed point ("random" criterion,
reference value 0.4621) and the alpha where it reaches perfect recovery
("perfect" criterion, reference value 2.2428); then a whole critical line
over the prior bias p_pos with the batched search (one batched SE solve
per bisection level). SE runs in float64.

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
SEARCH = dict(id="x", a0=0.1, alpha_min=0.1, alpha_max=3.0,
              model_builder=glm_state_evolution, prior_type="binary",
              output_type="door", output_width=1.5)


def critical_alpha(criterion, device, alpha_tol=1e-3):
    "The critical alpha of one criterion at p_pos = 0.51."
    return find_critical_alpha(mse_criterion=criterion, alpha_tol=alpha_tol,
                               prior_p_pos=0.51, device=device, **SEARCH)


def critical_line(p_pos, device, alpha_tol=1e-3):
    """The "perfect" critical alphas over the prior bias, batched: p_pos is
    a per-lane hyperparameter of BinaryPrior, so every bisection level is
    one batched SE solve."""
    return find_critical_alpha_batched(
        mse_criterion="perfect", alpha_tol=alpha_tol,
        grid_kwargs={"prior_p_pos": list(p_pos)}, device=device, **SEARCH)


def main(argv=None):
    args = _cli.parser(__doc__).parse_args(argv)
    device = _cli.device(args)
    found = {}
    for criterion, ref in REFERENCE:
        found[criterion] = alpha_c = float(critical_alpha(criterion, device))
        print(f"critical alpha (door width=1.5, {criterion}): "
              f"{alpha_c:.4f}  (reference CSV: {ref:.4f})")
    line = critical_line(P_POS, device)
    for p, a in zip(P_POS, line):
        print(f"  p_pos={p:.2f}: alpha_c={float(a):.4f}")
    found["line"] = [float(a) for a in line]
    return found


if __name__ == "__main__":
    main()
