"""The gallery's fast_paths against the JAX script examples/glm/fast_paths.py
on its own instances: the JAX script's builders at N = 256 (W, x and y
from ``np.random.RandomState``; the GLM's teacher sample from a JAX key),
the JAX side without x64 as the script runs, carried over by
``torch_parity.port_model`` in float32, and the port's ``run_glm``,
``run_relu`` and ``run_gated`` on them: the same dispatched solver classes,
n_iter within 2, r within 1e-3 of the largest |r|, mean v rtol 1e-3; the
gated solve converged in both, its v within 1e-3 of each package's float32
solve, its two phases' sweeps within 2.
"""
import importlib.util
from pathlib import Path

import jax
import numpy as np
import torch

from tramp_tpu.parallel import (
    EPSolver as JEPSolver, dispatch_solver as jdispatch)

from tramp_tpu_torch.examples.glm import fast_paths

from torch_parity import assert_close, port_model

REPO = Path(__file__).resolve().parents[1]
F32_RTOL = 1e-3


def _jax_fast_paths():
    "The JAX script examples/glm/fast_paths.py as a module."
    path = REPO / "examples" / "glm" / "fast_paths.py"
    spec = importlib.util.spec_from_file_location("jax_fast_paths", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _f32(j_post, post):
    r, jr = post["x"]["r"], j_post["x"]["r"]
    assert r.dtype == torch.float32
    assert_close(r, jr, F32_RTOL, "r")
    v, jv = float(post["x"]["v"].double().mean()), float(np.mean(
        np.asarray(j_post["x"]["v"], np.float64)))
    assert abs(v - jv) <= F32_RTOL * jv, (v, jv)


def test_fast_paths_against_jax():
    jfp = _jax_fast_paths()
    with jax.enable_x64(False):
        j_glm, x0 = jfp.build_glm(N=256)
        j_relu, x0r = jfp.build_relu_net(N=256)
        solver = jdispatch(j_glm, **fast_paths.SOLVE)
        j_post, j_n = solver.solve(j_glm)
        j_ep = JEPSolver(j_glm, damping=0.1, **fast_paths.SOLVE)
        j_post_ep, j_n_ep = j_ep.solve(j_glm)
        relu_solver = jdispatch(j_relu, damping=0.1, **fast_paths.SOLVE)
        j_post_relu, j_n_relu = relu_solver.solve(j_relu)
        j_gated, j_n_gated, j_conv, j_info = j_ep.solve_gated_bf16(j_glm)
        glm = port_model(j_glm, dtype=torch.float32)
        relu = port_model(j_relu, dtype=torch.float32)
    row, ep, post_ep = fast_paths.run_glm(glm, np.asarray(x0))
    assert row["solver"] == type(solver).__name__ == "SpectralVAMPSolver"
    assert abs(row["n_iter"] - int(j_n)) <= 2
    assert abs(row["n_iter_engine"] - int(j_n_ep)) <= 2
    _f32(j_post_ep, post_ep)
    got = fast_paths.run_relu(relu, x0r)
    assert got["solver"] == type(relu_solver).__name__ == "MLVAMPSolver"
    assert abs(got["n_iter"] - int(j_n_relu)) <= 2
    jv = float(np.mean(np.asarray(j_post_relu["x"]["v"], np.float64)))
    assert abs(got["v"] - jv) <= F32_RTOL * jv, (got["v"], jv)
    jr = np.asarray(j_post_relu["x"]["r"], np.float64)
    np.testing.assert_allclose(got["mse"], float(np.mean((jr - x0r) ** 2)),
                               rtol=F32_RTOL)
    gated = fast_paths.run_gated(ep, glm, post_ep)
    jv_g = float(np.mean(np.asarray(j_gated["x"]["v"], np.float64)))
    jv_f = float(np.mean(np.asarray(j_post_ep["x"]["v"], np.float64)))
    assert gated["conv"] and bool(j_conv)
    assert gated["v_rel_err_vs_f32"] < 1e-3
    assert abs(jv_g - jv_f) / jv_f < 1e-3
    assert abs(gated["n_iter_bf16"] - j_info["n_iter_bf16"]) <= 2
    assert abs(gated["n_iter_f32"] - j_info["n_iter_f32"]) <= 2
