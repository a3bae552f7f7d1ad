"""The compressed-sensing SE phase grid of the port against the benchmark's
plain SE reference (``portbench/reference/cs_glm_se.py``), float64 on the
CPU: ``se_phase_grid_records`` on a seeded 12 x 3 grid that holds a golden
alpha, point by point (v and n_iter); the reference against the pinned SE
rows of tests/test_golden_csv.py; the reference's node rule against a finer
rule; the grid's three steps (``build_se_grid``, ``solve_se_grid``,
``se_grid_records``) against the one call and against the sequence they
were split from, bit for bit; and with ``config.TRACE`` True the spans
``grid.build`` and ``grid.records`` once per grid and the count of
integrand evaluations (``utils.integration.nodes_evaluated``).

This file imports no JAX.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import tramp_tpu_torch as tt
from tramp_tpu_torch import config, trace
from tramp_tpu_torch.algos import CustomInit
from tramp_tpu_torch.lanes import stack_models
from tramp_tpu_torch.parallel import (
    SESolver, build_se_grid, grid_combos, se_grid_records,
    se_phase_grid_records, solve_se_grid,
)
from tramp_tpu_torch.utils import integration

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]
CS = dict(prior_type="gauss_bernoulli", output_type="gaussian",
          output_var=1e-11)
SE_CONFIG = dict(output_var=1e-11, prior_mean=0.0, prior_var=1.0)
GOLDEN_ALPHA = 0.4081632653061224
# tests/test_golden_csv.py:132-136 (alpha, v, rtol) at rho = 0.25
CS_SE_ROWS = [
    (0.02040816326530612, 2.449736425973765e-01, 1e-3),
    (0.40816326530612240, 5.299215508244257e-02, 1e-2),
    (0.81632653061224480, 5.553835940647028e-08, 5e-2),
]
#: the prior's average splits m +- 10 s into 5 segments of 8 panels of 16
#: nodes, and its beliefs measure sums a spike and a slab
NODES_PER_POINT = 2 * 5 * 8 * 16


def _reference():
    path = REPO / "portbench" / "reference" / "cs_glm_se.py"
    spec = importlib.util.spec_from_file_location("cs_glm_se_reference",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


REF = _reference()


def _grid(seed=18):
    "A seeded 12 x 3 (alpha, rho) grid holding one golden alpha."
    rng = np.random.default_rng(seed)
    alphas = np.sort(np.append(rng.uniform(0.05, 2.0, 11), GOLDEN_ALPHA))
    return {"alpha": alphas, "prior_rho": [0.15, 0.25, 0.6]}


KW = dict(ids=("x",), a0=0.0, max_iter=200, tol=1e-6, device="cpu", **CS)


@pytest.fixture(autouse=True)
def fresh_store(monkeypatch):
    monkeypatch.setattr(config, "TRACE", None)
    trace.reset()
    yield
    trace.reset()


@pytest.mark.parametrize("seed", [18, 19])
def test_the_grid_follows_the_plain_reference(seed):
    records = se_phase_grid_records(tt.glm_state_evolution, _grid(seed),
                                    **KW)
    alphas = [r["alpha"] for r in records]
    rhos = [r["prior_rho"] for r in records]
    v_ref, n_ref, conv = REF.solve(SE_CONFIG, alphas, rhos, 1e-6, 200)
    assert [r["n_iter"] for r in records] == n_ref.tolist()
    v = torch.tensor([r["v"] for r in records], dtype=torch.float64)
    torch.testing.assert_close(v, v_ref, rtol=1e-10, atol=0.0)
    assert bool(conv.all()) and GOLDEN_ALPHA in alphas


def test_the_reference_meets_the_pinned_rows():
    alphas = [a for a, _, _ in CS_SE_ROWS]
    v, n_iter, conv = REF.solve(SE_CONFIG, alphas, [0.25] * 3, 1e-6, 200)
    for (alpha, v_pin, rtol), got in zip(CS_SE_ROWS, v.tolist()):
        assert abs(got - v_pin) <= rtol * v_pin, (alpha, got, v_pin)
    assert bool(conv.all()) and int(n_iter.max()) < 200


def test_the_node_rule_against_a_finer_rule():
    """The fixed points of the 12 x 3 grid under the rule and under one of
    16 times the nodes (128 panels of 32): the same stops, v within 1e-5
    relative (4.8e-6 read at v = 6e-12, a fixed point at the precisions'
    clip), within 1e-7 at the golden row. Where the spike-slab layer has no
    break point inside the range (b* = 0 with a large ax) the rule's
    average departs further: 3.4e-3 at ax = 316, rho = 0.95, pinned below
    so that a change of the rule shows here."""
    grid = _grid()
    combos = grid_combos(grid)
    alphas = [c["alpha"].item() for c in combos]
    rhos = [c["prior_rho"].item() for c in combos]
    v, n_iter, _ = REF.solve(SE_CONFIG, alphas, rhos, 1e-6, 200)
    v_fine, n_fine, _ = REF.solve(SE_CONFIG, alphas, rhos, 1e-6, 200,
                                  rule=(128, 32))
    assert torch.equal(n_iter, n_fine)
    gap = (v - v_fine).abs() / v_fine
    assert float(gap.max()) <= 1e-5
    golden = [i for i, c in enumerate(combos)
              if c["alpha"] == GOLDEN_ALPHA and c["prior_rho"] == 0.25]
    assert float(gap[golden].max()) <= 1e-7
    ax = torch.tensor([[316.22776601683796], [0.5]], dtype=torch.float64)
    rho = torch.tensor([[0.95], [0.25]], dtype=torch.float64)
    coarse, fine = (REF.prior_variance(ax, rho, REF.panel_rule(
        *rule, torch.float64, "cpu")) for rule in ((8, 16), (128, 32)))
    departure = ((coarse - fine).abs() / fine)[:, 0].tolist()
    assert 3e-3 < departure[0] < 4e-3 and departure[1] <= 1e-10


def _records_of_the_sequence_split(model_builder, grid_kwargs, ids, a0,
                                   max_iter, tol, device, **model_kwargs):
    """``se_phase_grid_records`` as one function, as it was before its
    three steps were split out (no mesh)."""
    combos = grid_combos(grid_kwargs)
    models = [model_builder(**{k: v.item() for k, v in kw.items()},
                            **model_kwargs) for kw in combos]
    solver = SESolver(models[0], tol=tol, max_iter=max_iter, device=device)
    stacked = stack_models(models, device=solver.engine.device,
                           dtype=solver.engine.dtype)
    init = CustomInit(a_init=[(ids[0], "bwd", a0)])
    post, n_iter = solver.solve_batch(stacked, initializer=init)
    records = []
    for id in ids:
        v = post[id]["v"].double().cpu().numpy().reshape(len(models), -1)
        for i, kw in enumerate(combos):
            rec = {k: np.asarray(val).item() for k, val in kw.items()}
            rec.update(id=id, v=float(v.mean(axis=-1)[i]),
                       n_iter=int(n_iter[i]))
            records.append(rec)
    return records


def test_the_steps_give_the_records_bit_for_bit():
    kw = dict(KW, ids=("x", "z"))
    records = se_phase_grid_records(tt.glm_state_evolution, _grid(), **kw)
    grid = build_se_grid(tt.glm_state_evolution, _grid(), **kw)
    assert len(grid.combos) == 36 and grid.ids == ("x", "z")
    post, n_iter = solve_se_grid(grid)
    assert se_grid_records(grid, post, n_iter) == records
    assert _records_of_the_sequence_split(
        tt.glm_state_evolution, _grid(), **kw) == records


def test_spans_and_the_node_count(monkeypatch):
    off = se_phase_grid_records(tt.glm_state_evolution, _grid(), **KW)
    monkeypatch.setattr(config, "TRACE", True)
    before = integration.nodes_evaluated
    on = se_phase_grid_records(tt.glm_state_evolution, _grid(), **KW)
    counted = integration.nodes_evaluated - before
    assert on == off
    names = [r.name for r in trace.records()]
    assert names.count("grid.build") == names.count("grid.records") == 1
    assert names.count("solve") == 1
    iterations = max(r["n_iter"] for r in on)
    assert counted == iterations * len(on) * NODES_PER_POINT
    assert {"grid.build", "grid.records"} <= set(trace.NAMES)
    builds = [r for r in trace.records() if r.name == "grid.build"]
    assert builds[0].solve is None and builds[0].parent is None
