"""The reader of gb_prior_roofline on a synthetic run and trace (the
helpers of test_portbench_readers.py): the prior kernel's launches matched
by name, none matched, and the one-instance cell's lanes."""
import pytest

from portbench import counts, trace
from portbench.tests.test_portbench_readers import events, fake_run, read

US = 1e6


def _with_prior_kernels(duration_s):
    """The synthetic trace with a posterior and a message launch of
    ``duration_s`` each in every window."""
    out = list(events())
    for t in (0.0, 2.0):
        out += [("void (anonymous namespace)::gb_prior_posterior_kernel"
                 "<double, 2>(double const*, long, ...)", True,
                 (t + 0.75) * US, (t + 0.75 + duration_s) * US),
                ("void (anonymous namespace)::gb_prior_message_kernel"
                 "<double, 2>(double const*, long, ...)", True,
                 (t + 0.8) * US, (t + 0.8 + duration_s) * US)]
    return trace.Timeline.from_events(out)


@pytest.mark.parametrize("cell, lanes", [
    ("relu_net_f64.lanes2048", 2048), ("cs_glm_f64.lanes2048", 2048),
    ("relu_net_f64.single", 1)])
def test_matched_launches_over_their_device_time(cell, lanes):
    run = fake_run(lanes=lanes, config=cell)
    run.timeline = _with_prior_kernels(1e-4)
    N = run.config["N"]
    bound_s = (2 * lanes * N + 4 * lanes) * 8 / counts.HBM_BYTES_PER_S
    # four launches of 0.1 ms, each with the bound of one
    assert read("gb_prior_roofline", run) == pytest.approx(
        100.0 * 4 * bound_s / 4e-4)


def test_nothing_where_no_launch_matched():
    notes = []
    run = fake_run()
    run.note = notes.append
    assert read("gb_prior_roofline", run) is None
    assert notes and "gb_prior" in notes[0]
    assert read("gb_prior_roofline", fake_run(timeline=False)) is None
