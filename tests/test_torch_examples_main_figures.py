"""The figures gallery scripts end to end through ``main(["--device",
"cpu", "--out", dir])`` at tiny sizes (each script's grids patched): each
writes its file with the JAX script's columns, in its order, and finite
values; the mesh scripts run on a gloo world of this one process and
leave no process group behind that they made.
"""
import csv
import functools
import json

import numpy as np
import pytest
import torch
import torch.distributed as dist

from tramp_tpu_torch.examples.figures import (
    sparse_regression, sparse_phase_retrieval, phase_diagram_sweep,
    se_grid_scaling, benchmark)

torch.set_num_threads(1)
CPU = ["--device", "cpu"]


def read_csv(path):
    with open(path) as f:
        rows = list(csv.reader(f))
    return rows[0], rows[1:]


@pytest.mark.parametrize("module,name", [
    (sparse_regression, "sparse_regression.csv"),
    (sparse_phase_retrieval, "sparse_phase_retrieval.csv"),
], ids=["sparse_regression", "sparse_phase_retrieval"])
def test_jmlr_main(module, name, monkeypatch, tmp_path):
    "EP on 2 seeds as lanes at 2 alphas, SE and BO on 3 grid points."
    monkeypatch.setattr(module, "grids", lambda big: (
        40, 2, np.array([0.3, 1.0]), np.array([0.2, 0.6, 1.0])))
    df = module.main(CPU + ["--out", str(tmp_path)])
    header, rows = read_csv(tmp_path / name)
    assert header == ["source", "alpha", "rho", "v"] == list(df.columns)
    assert [r[0] for r in rows] == ["EP"] * 2 + ["SE"] * 3 + ["BO"] * 3
    assert np.isfinite([float(r[3]) for r in rows]).all()
    # Bayes-optimal (informed) never above the uninformed SE, up to the
    # solves' relative stop tolerance 1e-6
    se, bo = df[df.source == "SE"]["v"], df[df.source == "BO"]["v"]
    assert (bo.to_numpy() <= se.to_numpy() * (1 + 1e-6)).all()


def test_phase_diagram_main(monkeypatch, tmp_path):
    monkeypatch.setattr(phase_diagram_sweep, "grid", lambda big: [
        (0.3, 0.2), (0.3, 0.6), (0.9, 0.2)])
    before = dist.is_initialized()
    out = phase_diagram_sweep.main(CPU + ["--out", str(tmp_path)])
    assert dist.is_initialized() == before
    header, rows = read_csv(tmp_path / "phase_diagram.csv")
    assert header == ["alpha", "rho", "v_SE"] and len(rows) == 3
    assert np.allclose([float(r[2]) for r in rows], out["v"], rtol=0)
    assert out["devices"] == 1 and out["seconds"] > 0


def test_se_grid_scaling_main(monkeypatch, tmp_path):
    monkeypatch.setattr(se_grid_scaling, "GRID", dict(
        alpha=np.array([0.3, 0.8]), prior_rho=[0.25]))
    monkeypatch.setattr(se_grid_scaling, "flops_per_process",
                        functools.partial(se_grid_scaling.flops_per_process,
                                          N=32, batch=2))
    before = dist.is_initialized()
    report, _ = se_grid_scaling.main(CPU + ["--out", str(tmp_path)])
    assert dist.is_initialized() == before
    header, rows = read_csv(tmp_path / "se_grid_scaling.csv")
    assert header == ["alpha", "prior_rho", "id", "v", "n_iter"]
    assert len(rows) == 2
    saved = json.loads((tmp_path / "se_grid_scaling.json").read_text())
    assert saved == json.loads(json.dumps(report))
    assert report["processes"] == 1 and report["se_grid_points"] == 2
    # the batched EP solve's products: at least one iteration's matvecs
    # with U and V (2 x 2 k N each, k = 16) on both lanes
    assert report["flop_counter_flops_per_process"] >= 2 * 2 * 2 * 16 * 32


def test_flop_counter_counts_products_only():
    "FlopCounterMode sees torch.mm and not an elementwise operation."
    from torch.utils.flop_counter import FlopCounterMode
    a = torch.randn(8, 4)
    with FlopCounterMode(display=False) as counter:
        torch.exp(a) * a + a
    assert counter.get_total_flops() == 0
    with FlopCounterMode(display=False) as counter:
        a @ a.T
    assert counter.get_total_flops() == 2 * 8 * 8 * 4


def test_benchmark_main(monkeypatch, tmp_path):
    monkeypatch.setattr(benchmark, "sizes", lambda big: (40, [0.5]))
    benchmark.main(CPU + ["--out", str(tmp_path)])
    header, rows = read_csv(tmp_path / "benchmark.csv")
    assert header == ["ep_mse", "ep_time", "lasso_mse", "lasso_time",
                      "alpha", "seed"]
    assert [r[-1] for r in rows] == ["0", "1"]
    assert np.isfinite([float(r[c]) for r in rows for c in (0, 1)]).all()


def test_benchmark_without_scikit_learn_writes_nan(monkeypatch):
    "Without scikit-learn the Lasso columns are NaN, as in the JAX script."
    import builtins
    real = builtins.__import__

    def no_sklearn(name, *args, **kw):
        if name.startswith("sklearn"):
            raise ImportError(name)
        return real(name, *args, **kw)
    monkeypatch.setattr(builtins, "__import__", no_sklearn)
    out = benchmark.run_lasso(0.5, 40, 0.05, 1e-2, 0, torch.device("cpu"))
    assert out["source"] == "Lasso"
    assert np.isnan(out["mse"]) and np.isnan(out["time"])
