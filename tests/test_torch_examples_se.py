"""The gallery's state-evolution columns and deterministic instances
against the outputs the JAX package committed under examples/*/output/
(its default-size runs), on the CPU in float64.

- compressed_sensing's and perceptron's v_SE at every committed alpha,
  phase_diagram_sweep's 96 v_SE and matrix_factorization's mse_x_se: rtol
  1e-10 (the same quadrature in the same order, float64);
- sparse_gradient and image_deconvolution draw their instances from
  ``np.random.RandomState(0)`` as the JAX scripts do, so the teacher is
  equal and EP's posterior mean is held at rtol 1e-8 of the largest
  magnitude;
- matrix_factorization's mse_x_emp (the same ``RandomState(7)``
  instances) within 3.3 relative sd of the committed value, the sd of
  mse_x_emp over 12 solves of these instances with the input multiplied by
  1 + 1e-13 g (``chip_smoke.chaos_ensemble``, phase 17a): the VAMP solve
  amplifies rounding about 1e9 in its first iterations (ROADMAP Queue 3),
  so another summation order moves mse_x_emp by that much. The band is
  wide where the solve is most chaotic (Delta 0.2).

This file imports no JAX: the reference is the committed files.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

from tramp_tpu_torch.examples.glm import compressed_sensing, perceptron
from tramp_tpu_torch.examples.figures import phase_diagram_sweep
from tramp_tpu_torch.examples.low_rank import matrix_factorization
from tramp_tpu_torch.examples.sparse import (
    sparse_gradient, image_deconvolution)

# one worker per core runs the suite: no thread pool on top
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
OUT = REPO / "examples"
SE_RTOL = 1e-10
EP_RTOL = 1e-8
#: relative sd of mse_x_emp by Delta under 1e-13 input perturbations
#: (chip_smoke.py phase 17a on an NVIDIA H100 80GB HBM3 at 700 W)
MF_EMP_RSD = {0.2: 0.1753, 0.4: 0.03946, 0.7: 0.01437, 1.0: 0.002239}
CPU = torch.device("cpu")


def committed(rel):
    "A committed CSV's columns by header name."
    path = OUT / rel
    header = path.read_text().splitlines()[0].lstrip("# ").split(",")
    data = np.loadtxt(path, delimiter=",", skiprows=1, ndmin=2)
    return {h: data[:, i] for i, h in enumerate(header)}


CS = committed("glm/output/compressed_sensing_ep_vs_se.csv")
PERCEPTRON = committed("glm/output/perceptron_ep_vs_se.csv")


def test_default_grids_are_the_committed_ones():
    "The scripts' default alphas are the committed rows'."
    assert np.array_equal(compressed_sensing.sizes(False)[1], CS["alpha"])
    assert np.array_equal(perceptron.sizes(False)[1], PERCEPTRON["alpha"])


@pytest.mark.parametrize("row", range(len(CS["alpha"])))
def test_compressed_sensing_v_se(row):
    got = compressed_sensing.se_v(CS["alpha"][row], 0.25, 1e-2, CPU)
    np.testing.assert_allclose(got, CS["v_SE"][row], rtol=SE_RTOL)


@pytest.mark.parametrize("row", range(len(PERCEPTRON["alpha"])))
def test_perceptron_v_se(row):
    got = perceptron.se_v(PERCEPTRON["alpha"][row], CPU)
    np.testing.assert_allclose(got, PERCEPTRON["v_SE"][row], rtol=SE_RTOL)


def test_phase_diagram_v_se():
    """The 96-point grid as one batched SE solve on a gloo mesh of this one
    process: every v_SE of the committed phase_diagram.csv."""
    import torch.distributed as dist
    from tramp_tpu_torch.parallel import make_mesh
    want = committed("figures/output/phase_diagram.csv")
    points = phase_diagram_sweep.grid(False)
    assert np.array_equal(np.asarray(points),
                          np.stack([want["alpha"], want["rho"]], 1))
    made = not dist.is_initialized()
    mesh = make_mesh(None, ("data", "model"), device="cpu")
    try:
        v, _ = phase_diagram_sweep.solve_grid(points, CPU, mesh)
    finally:
        if made:
            dist.destroy_process_group()
    np.testing.assert_allclose(v, want["v_SE"], rtol=SE_RTOL)


MF = committed("low_rank/output/matrix_factorization_ep_vs_se.csv")


@pytest.mark.parametrize("row", range(len(MF["delta"])))
def test_matrix_factorization_mse_x_se(row):
    got = matrix_factorization.mse_se(MF["delta"][row], 128, 128, CPU)
    np.testing.assert_allclose(got, MF["mse_x_se"][row], rtol=SE_RTOL)


def test_matrix_factorization_mse_x_emp_in_its_band():
    "The default sweep's deltas and each mse_x_emp in its band."
    assert np.array_equal(matrix_factorization.deltas(False), MF["delta"])
    for Delta, want in zip(MF["delta"], MF["mse_x_emp"]):
        got, vz_u = matrix_factorization.mse_empirical(Delta, 128, 128, 4,
                                                       CPU)
        band = 3.3 * MF_EMP_RSD[float(Delta)] * want
        assert abs(got - want) <= band, (Delta, got, want)
        assert 0 < vz_u < 1.5


def test_sparse_gradient_recovery_equals_the_committed_file():
    want = np.loadtxt(OUT / "sparse" / "output" /
                      "sparse_gradient_recovery.csv", delimiter=",")
    x0, r = sparse_gradient.run(128, CPU)
    assert np.array_equal(x0, want[:, 0])
    np.testing.assert_allclose(r, want[:, 1],
                               atol=EP_RTOL * np.abs(want[:, 1]).max())


def test_deconvolution_equals_the_committed_file():
    want = np.load(OUT / "sparse" / "output" / "deconvolution.npz")
    x0, y, r = image_deconvolution.run(32, CPU)
    assert np.array_equal(x0, want["x0"])
    np.testing.assert_allclose(y, want["y"],
                               atol=EP_RTOL * np.abs(want["y"]).max())
    np.testing.assert_allclose(r, want["r"],
                               atol=EP_RTOL * np.abs(want["r"]).max())


def _rows_of(path, name):
    "The list literal ``name`` of a test module, read from its source."
    import ast
    tree = ast.parse(path.read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == name for t in node.targets):
            return ast.literal_eval(node.value)
    raise AssertionError(f"{name} not in {path}")


@pytest.mark.parametrize("name", ["CS_EP_ROWS", "PERCEPTRON_EP_ROWS"])
def test_golden_rows_are_the_jax_tests_rows(name):
    """The port's copy of tests/test_ep_golden.py's EP golden rows (the
    card holds its ensembles to them; that machine has no JAX) equals the
    test file's, as do the ensemble's size and band."""
    from tramp_tpu_torch.examples.glm import golden_rows
    path = REPO / "tests" / "test_ep_golden.py"
    assert getattr(golden_rows, name) == _rows_of(path, name)
    source = path.read_text()
    assert f"N_SEEDS = {golden_rows.N_SEEDS}\n" in source
    assert f"N = {golden_rows.N}\n" in source
    assert f"band = {golden_rows.BAND_SDS} * sd + atol" in source


def test_golden_ensemble_on_the_cpu():
    """One row of each family at the test's size (N = 1000, 8 seeds as
    lanes) on the CPU: every check inside its band."""
    from tramp_tpu_torch.examples.glm import golden_rows as g
    for builder, row in (
            (lambda gen: g.build_cs(*g.CS_EP_ROWS[1][:2], gen, CPU),
             g.CS_EP_ROWS[1]),
            (lambda gen: g.build_perceptron(*g.PERCEPTRON_EP_ROWS[1][:2],
                                            gen, CPU),
             g.PERCEPTRON_EP_ROWS[1] + (0.0,))):
        v_ep, mse, n_iter = g.run_ensemble(builder, CPU)
        alpha, _, v_se, v_ep_csv, mse_csv, atol = row
        assert v_ep.shape == mse.shape == n_iter.shape == (g.N_SEEDS,)
        assert g.in_band(v_ep, v_ep_csv, atol)[0]
        assert g.in_band(mse, mse_csv, atol)[0]
        assert g.in_band(v_ep, v_se, atol + 0.05 * v_se)[0]
