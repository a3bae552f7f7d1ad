"""The door gallery script's searches as the lanes of one batched
bisection (``critical_alpha_door.critical_alphas``: the "random" and the
"perfect" criterion at p_pos 0.51, the two lanes that the script's own
sequential searches cover) against the sequential search of each criterion
(``critical_alpha``, the JAX script's protocol), float64 on the CPU, at
alpha_tol 0.05, six bisection levels of the script's twelve (the door's SE
takes up to 1.7 s a solve here): the same alphas, bit for bit."""
import torch

from tramp_tpu_torch.examples.glm import critical_alpha_door as door

torch.set_num_threads(1)
ALPHA_TOL = 0.05


def test_lanes_give_the_sequential_alphas():
    random, (perfect,) = door.critical_alphas([0.51], "cpu",
                                              alpha_tol=ALPHA_TOL)
    found = {"random": random, "perfect": perfect}
    for criterion, ref in door.REFERENCE:
        want = door.critical_alpha(criterion, "cpu", alpha_tol=ALPHA_TOL)
        assert found[criterion] == want, criterion
        assert abs(want - ref) <= ALPHA_TOL
    assert random < perfect
