"""quad_nodes_per_iter: the port's count of integrand evaluations
(``tramp_tpu_torch.utils.integration.nodes_evaluated``, lanes x nodes per
measure) over the traced calls' solves, per loop iteration of those calls.
Frozen points are swept too, so it falls when live points are compacted.
Nothing is read from a program that does not count them."""


def read(run):
    calls = run.traced_calls
    if not calls or any(c.get("quad_nodes") is None for c in calls):
        run.note("quad_nodes_per_iter: the program counts no integrand "
                 "evaluations")
        return None
    return (sum(c["quad_nodes"] for c in calls)
            / sum(c["iterations"] for c in calls))
