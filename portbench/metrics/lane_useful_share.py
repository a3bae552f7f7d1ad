"""lane_useful_share: the lane-iterations the instances needed (the sum of
their n_iter) over those the loop ran (lanes times the loop's iterations,
frozen lanes included), in %, over every call of the window."""


def read(run):
    ran = sum(c["lanes"] * c["iterations"] for c in run.calls)
    return 100.0 * sum(c["n_iter_sum"] for c in run.calls) / ran if ran \
        else None
