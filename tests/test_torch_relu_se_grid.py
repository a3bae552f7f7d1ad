"""The relu GLM's SE phase grid of the port against the benchmark's plain
relu SE reference (``portbench/reference/relu_se.py``), float64 on the
CPU: ``se_phase_grid_records`` on a seeded 4 x 3 (alpha, rho) grid, v of x,
z and a and n_iter point by point; the count of integrand evaluations per
loop iteration (``utils.integration.nodes_evaluated``: the prior's 2 x 640
nodes and the relu channel's 2 x 20,000 a point); a point solved alone
against its lane of the grid; the reference against the JAX package's SE
of the same model; the reference's node rule against a finer rule; the
span ``se.channel_measure`` once per channel measure of an eager sweep;
and an iteration of the grid's loop that copies nothing from the host, as
a capture needs.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import tramp_tpu as jt
from tramp_tpu import channels as jchannels
from tramp_tpu.likelihoods import GaussianLikelihood as JGaussianLikelihood
from tramp_tpu.priors import GaussBernoulliPrior as JGaussBernoulliPrior

from tramp_tpu_torch import config, trace
from tramp_tpu_torch.parallel import (
    SESolver, build_se_grid, se_grid_records, solve_se_grid,
)
from tramp_tpu_torch.utils import integration

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from portbench.configs.relu_se import relu_glm  # noqa: E402
from portbench.reference import relu_se as REF  # noqa: E402

torch.set_num_threads(1)
IDS = ("x", "z", "a")
SE_CONFIG = dict(output_var=1e-2, prior_mean=0.0, prior_var=1.0)
KW = dict(ids=IDS, max_iter=200, tol=1e-6, device="cpu", **SE_CONFIG)
#: integrand evaluations of one sweep of one point: the prior's average, 2
#: x 640 nodes, and the relu channel's forward and backward errors, each 2
#: regions x 100 x 100 nodes
NODES_PER_POINT = 2 * 640 + 2 * 20_000


@pytest.fixture(autouse=True)
def fresh_store(monkeypatch):
    monkeypatch.setattr(config, "TRACE", None)
    trace.reset()
    yield
    trace.reset()


def _grid(seed):
    "A seeded 4 x 3 (alpha, rho) grid."
    rng = np.random.default_rng(seed)
    return {"alpha": np.sort(rng.uniform(0.1, 2.0, 4)),
            "prior_rho": np.array([0.05, 0.3, 0.9])}


def _solve(grid):
    """(the grid, its v (points, ids), n_iter (points,), the integrand
    evaluations of the solve)."""
    g = build_se_grid(relu_glm, grid, **KW)
    before = integration.nodes_evaluated
    post, n_iter = solve_se_grid(g)
    nodes = integration.nodes_evaluated - before
    records = se_grid_records(g, post, n_iter)
    points = len(g.combos)
    v = np.array([r["v"] for r in records]).reshape(len(IDS), points).T
    return g, v, n_iter.numpy(), nodes


#: a 2 x 2 grid, for what needs no more than a few points
TWO_BY_TWO = {"alpha": np.array([0.4, 1.7]), "prior_rho": np.array([0.2, 0.6])}


def _points(g):
    return ([c["alpha"].item() for c in g.combos],
            [c["prior_rho"].item() for c in g.combos])


@pytest.mark.parametrize("seed", [23, 24])
def test_the_grid_follows_the_plain_reference(seed):
    g, v, n_iter, _ = _solve(_grid(seed))
    v_ref, n_ref, conv = REF.solve(SE_CONFIG, *_points(g), 1e-6, 200)
    assert n_iter.tolist() == n_ref.tolist()
    np.testing.assert_allclose(v, v_ref.numpy(), rtol=1e-10, atol=0.0)
    assert bool(conv.all()) and n_iter.max() < 200


def test_the_nodes_counted_per_iteration():
    g, _, n_iter, nodes = _solve(TWO_BY_TWO)
    assert nodes == len(g.combos) * NODES_PER_POINT * int(n_iter.max())


def test_a_point_alone_matches_its_lane():
    g, v, n_iter, _ = _solve(_grid(26))
    alphas, rhos = _points(g)
    solver = SESolver(relu_glm(alphas[0], rhos[0], **SE_CONFIG),
                      device="cpu")
    for lane in (0, 5, len(alphas) - 1):
        post, n = solver.solve(relu_glm(alphas[lane], rhos[lane],
                                        **SE_CONFIG))
        assert int(n) == n_iter[lane]
        np.testing.assert_allclose([float(post[i]["v"]) for i in IDS],
                                   v[lane], rtol=1e-12, atol=0.0)


@pytest.mark.parametrize("alpha, rho", [(0.5, 0.25), (1.3, 0.6)])
def test_the_reference_agrees_with_the_jax_package(alpha, rho):
    model = (JGaussBernoulliPrior(size=1, rho=rho) @ jt.V(id="x")
             @ jchannels.MarchenkoPasturChannel(alpha) @ jt.V(id="z")
             @ jchannels.ReluChannel() @ jt.V(id="a")
             @ JGaussianLikelihood(y=None, var=1e-2)).to_model()
    se = jt.StateEvolution(model).iterate(max_iter=200)
    want = [float(np.mean(np.asarray(se.get_variable_data(i)["v"])))
            for i in IDS]
    v, n_iter, conv = REF.solve(SE_CONFIG, [alpha], [rho], 1e-6, 200)
    assert int(n_iter[0]) == se.n_iter and bool(conv[0])
    np.testing.assert_allclose(v[0].numpy(), want, rtol=1e-12, atol=0.0)


def test_the_node_rule_against_a_finer_rule():
    """Three points under the program's rule (10 panels of 10 nodes per
    axis) and under one of 4 times the nodes per axis (20 panels of 20),
    which a rule of 40 panels of 20 matches to 1e-8: the same stops, and
    the rule's departure pinned, so that a change of the rule shows here.
    It grows with rho: 1.7e-10 at alpha 0.1, rho 0.05, 7.9e-5 at alpha 2,
    rho 0.25 and 2.43e-3 of a's v at alpha 1, rho 0.95, where the regions'
    probabilities turn within a panel."""
    alphas, rhos = [0.1, 2.0, 1.0], [0.05, 0.25, 0.95]
    v, n_iter, _ = REF.solve(SE_CONFIG, alphas, rhos, 1e-6, 200)
    v_fine, n_fine, _ = REF.solve(SE_CONFIG, alphas, rhos, 1e-6, 200,
                                  rule=(20, 20))
    assert torch.equal(n_iter, n_fine)
    gap = ((v - v_fine).abs() / v_fine).amax(1).tolist()
    assert gap[0] <= 1e-9 and 5e-5 < gap[1] < 1e-4 and 2e-3 < gap[2] < 3e-3


def test_the_channel_measure_span_once_per_measure(monkeypatch):
    monkeypatch.setattr(config, "TRACE", True)
    g, _, n_iter, _ = _solve(TWO_BY_TWO)
    spans = trace.summary()
    iterations = int(n_iter.max())
    assert spans["sweep"]["count"] == iterations
    # a forward and a backward error per sweep, inside the sweep
    assert spans["se.channel_measure"]["count"] == 2 * iterations
    inside = [r for r in trace.records() if r.name == "se.channel_measure"]
    assert {r.parent for r in inside} == {"sweep"}
    trace.reset()
    monkeypatch.setattr(config, "TRACE", None)
    _solve(TWO_BY_TWO)
    assert trace.summary() == {}


class _HostData(TorchDispatchMode):
    "Records the operations no capture can hold: host data, device reads."

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.__name__.split(".")[0] in ("lift_fresh", "_local_scalar_dense",
                                           "is_nonzero"):
            self.seen.append(str(func))
        return func(*args, **(kwargs or {}))


def test_an_iteration_copies_nothing_from_the_host():
    g = build_se_grid(relu_glm, TWO_BY_TWO, **KW)
    solver, model = g.solver, g.stacked
    B = len(g.combos)
    eng = solver.engine
    state = solver._with_lanes(solver.init_state(None), B)
    aux = eng._fill_aux(model, state, eng._prepare(model))
    loop_state = solver._start(model, aux, B, state)
    # the first iteration moves the quadrature's nodes to the device, once
    solver._iterate(model, aux, B, loop_state, solver.tol)
    with _HostData() as seen:
        solver._iterate(model, aux, B, loop_state, solver.tol)
    assert seen.seen == []
