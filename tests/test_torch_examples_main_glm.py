"""The glm gallery scripts end to end through ``main(["--device", "cpu",
"--out", dir])`` at tiny sizes (each script's ``sizes`` or builder
patched): each writes its file with the JAX script's columns, in the JAX
script's order, and finite values. The door's bisections take minutes on
the CPU, so its ``main`` runs with the searches recorded (their arguments
held), and one test evaluates the door's "random" criterion on both sides
of its critical alpha with the real state evolution.
"""
import csv
import functools

import numpy as np
import pytest
import torch

from tramp_tpu_torch.examples.glm import (
    compressed_sensing, perceptron, phase_retrieval, critical_alpha_door,
    two_layer_phase_retrieval, cs_universality, fast_paths)

torch.set_num_threads(1)
CPU = ["--device", "cpu"]


def read_csv(path):
    with open(path) as f:
        rows = list(csv.reader(f))
    return rows[0], rows[1:]


def finite(rows, columns):
    values = np.array([[float(r[c]) for c in columns] for r in rows])
    return bool(np.isfinite(values).all())


@pytest.mark.parametrize("module,sizes,name,header", [
    (compressed_sensing, (40, [0.3, 0.8]), "compressed_sensing_ep_vs_se.csv",
     ["v_EP", "mse_EP", "v_SE", "alpha", "seed"]),
    (perceptron, (40, [0.5, 1.5]), "perceptron_ep_vs_se.csv",
     ["v_EP", "mse_EP", "v_SE", "alpha", "seed"]),
    (phase_retrieval, (24, [2.0]), "phase_retrieval_ep.csv",
     ["mse_EP", "v_EP", "alpha", "seed"]),
], ids=["compressed_sensing", "perceptron", "phase_retrieval"])
def test_sweep_main_writes_the_jax_columns(module, sizes, name, header,
                                           monkeypatch, tmp_path):
    monkeypatch.setattr(module, "sizes", lambda big: sizes)
    df = module.main(CPU + ["--out", str(tmp_path)])
    got, rows = read_csv(tmp_path / name)
    assert got == header and list(df.columns) == header
    assert len(rows) == len(sizes[1]) and finite(rows, range(len(header)))


def test_cs_universality_main(monkeypatch, tmp_path):
    monkeypatch.setattr(cs_universality, "sizes",
                        lambda big: (40, [0.5], [0.25]))
    cs_universality.main(CPU + ["--out", str(tmp_path)])
    header, rows = read_csv(tmp_path / "cs_universality.csv")
    assert header == ["source", "x_id", "v", "n_iter", "f", "prior_rho",
                      "alpha"]
    # SE, EP and mse for each of the four functions
    assert len(rows) == 3 * 4 and finite(rows, [2])
    assert {r[4] for r in rows} == set(cs_universality.FUNCTIONS)


def test_two_layer_phase_retrieval_main(monkeypatch, tmp_path):
    monkeypatch.setattr(two_layer_phase_retrieval, "sizes", lambda big: 12)
    out = two_layer_phase_retrieval.main(CPU + ["--out", str(tmp_path)])
    header, rows = read_csv(tmp_path / "two_layer_pr.csv")
    assert header == ["N", "M1", "M2", "phase_mse", "v"]
    assert rows[0][:3] == ["12", "36", "36"] and finite(rows, [3, 4])
    assert out["phase_mse"] < out["tau_x"]


def test_fast_paths_main(monkeypatch):
    for name in ("build_glm", "build_relu_net"):
        monkeypatch.setattr(fast_paths, name, functools.partial(
            getattr(fast_paths, name), N=128))
    out = fast_paths.main(CPU)
    assert out["glm"]["solver"] == "SpectralVAMPSolver"
    assert out["relu"]["solver"] == "MLVAMPSolver"
    assert out["gated"]["conv"] and out["gated"]["v_rel_err_vs_f32"] < 1e-3


def test_critical_alpha_door_main_plumbing(monkeypatch):
    """main's searches get the JAX script's arguments, as the lanes of one
    batched search (lane 0 "random" at p_pos 0.51, then "perfect" over the
    line's p_pos); their results print."""
    calls = []

    def batched(**kw):
        calls.append(kw)
        return torch.arange(len(kw["grid_kwargs"]["prior_p_pos"]),
                            dtype=torch.float64)
    monkeypatch.setattr(critical_alpha_door, "find_critical_alpha_batched",
                        batched)
    found = critical_alpha_door.main(CPU)
    common = dict(id="x", a0=0.1, alpha_min=0.1, alpha_max=3.0,
                  alpha_tol=1e-3, prior_type="binary", output_type="door",
                  output_width=1.5, device=torch.device("cpu"))
    (kw,) = calls
    assert {k: kw[k] for k in common} == common
    assert kw["grid_kwargs"] == {"prior_p_pos": [0.51, 0.51, 0.6, 0.7, 0.8]}
    assert kw["mse_criterion"] == ["random"] + ["perfect"] * 4
    assert found == {"random": 0.0, "perfect": 1.0,
                     "line": [1.0, 2.0, 3.0, 4.0]}


def test_door_random_criterion_flips_at_its_critical_alpha():
    """The weakly informed SE stays at the random fixed point just below
    the reference's 0.4621 and leaves it just above (float64)."""
    from tramp_tpu_torch import glm_state_evolution
    from tramp_tpu_torch.experiments import find_state_evolution_mse
    kw = dict(prior_type="binary", output_type="door", output_width=1.5,
              prior_p_pos=0.51)
    tau = 1.0     # the binary prior's second moment
    v = [find_state_evolution_mse("x", 0.1, alpha, glm_state_evolution,
                                  device="cpu", **kw)
         for alpha in (0.44, 0.49)]
    assert abs(v[0] - tau) <= 1e-3 < abs(v[1] - tau), v


def test_door_random_critical_alpha_on_a_narrow_window():
    """The script's search on a window around the reference's 0.4621 with
    alpha_tol 0.01: the bisection ends within 0.01 of it."""
    from tramp_tpu_torch.experiments import find_critical_alpha
    search = dict(critical_alpha_door.SEARCH, alpha_min=0.40,
                  alpha_max=0.52)
    alpha_c = find_critical_alpha(mse_criterion="random", alpha_tol=0.01,
                                  prior_p_pos=0.51, device="cpu", **search)
    ref = dict(critical_alpha_door.REFERENCE)["random"]
    assert abs(alpha_c - ref) <= 0.01, alpha_c
