"""se_nodes_per_iter: the port's count of integrand evaluations
(``tramp_tpu_torch.utils.integration.nodes_evaluated``, lanes x nodes per
measure: the prior's average and the piecewise-linear channel's 2-D
measure) over the traced calls' solves, per loop iteration of those calls.
Frozen points are swept too. Nothing is read from a program that counts no
integrand evaluations, nor from one whose piecewise-linear channel's
measure runs outside the span ``se.channel_measure`` (``trace.NAMES``):
that measure's nodes went uncounted before the span was opened there."""


def read(run):
    try:
        from tramp_tpu_torch import trace
    except ImportError:
        return None
    if "se.channel_measure" not in getattr(trace, "NAMES", ()):
        run.note("se_nodes_per_iter: the program opens no "
                 "se.channel_measure span")
        return None
    calls = run.traced_calls
    if not calls or any(c.get("quad_nodes") is None for c in calls):
        run.note("se_nodes_per_iter: the program counts no integrand "
                 "evaluations")
        return None
    return (sum(c["quad_nodes"] for c in calls)
            / sum(c["iterations"] for c in calls))
