"""Shared helpers of the tramp_tpu_torch parity tests: the exporter that
turns a tramp_tpu Model and its engine state into the numpy description
that tramp_tpu_torch.convert reads, and the comparison helper.

Both packages get identical float64 inputs: JAX runs with x64
(tests/conftest.py), the port in torch.float64 on the CPU.
"""
import numpy as np
import torch

from tramp_tpu.base import Variable

# The suite runs one process per core (pytest-xdist): a thread pool per
# process on top of that slows every test down, and the arrays here are small.
torch.set_num_threads(1)


def _np(x):
    return None if x is None else np.asarray(x)


def describe_factor(factor):
    "The convert.factor_from_description dict of a tramp_tpu factor."
    cls = type(factor)
    meta = {f: getattr(factor, f) for f in cls._meta_fields}
    if "ensemble" in meta:
        # by class name and constructor keywords: the port builds its own
        meta["ensemble"] = {"class": type(meta["ensemble"]).__name__,
                            "alpha": float(meta["ensemble"].alpha)}
    return {"class": cls.__name__,
            "data": {f: _np(getattr(factor, f)) for f in cls._data_fields},
            "meta": meta}


def describe_model(model):
    "The convert.model_from_description dict of a tramp_tpu Model."
    dag = model.model_dag.dag
    nodes = dag.nodes
    index = {n: i for i, n in enumerate(nodes)}
    out = [{"class": type(n).__name__, "id": n.id, "n_prev": n.n_prev,
            "n_next": n.n_next}
           if isinstance(n, Variable) else describe_factor(n)
           for n in nodes]
    return {"nodes": out,
            "edges": [(index[u], index[v]) for u, v in dag.edges]}


def port_model(jax_model, dtype=torch.float64):
    """The port's Model of a tramp_tpu Model, on the CPU: the same arrays,
    the JAX SVD carried over."""
    from tramp_tpu_torch import convert
    return convert.model_from_description(describe_model(jax_model),
                                          device="cpu", dtype=dtype)


def describe_state(state, n_slots):
    "(slots, cache) of a tramp_tpu engine state, as numpy."
    slots = [{k: np.asarray(v) for k, v in msg.items()}
             for msg in state[:n_slots]]
    cache = None
    if len(state) > n_slots:
        cache = {k: np.asarray(v) for k, v in state[n_slots].items()}
    return slots, cache


def describe_second_moments(model):
    "{variable id: tau} of a tramp_tpu Model (init_second_moments), as numpy."
    return {id: np.asarray(tau)
            for id, tau in model.get_second_moments().items()}


def to_numpy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_close(actual, expected, rtol, what=""):
    """``|actual - expected| <= rtol * (|expected| + max|expected|)``
    elementwise, with shapes equal; ``actual`` from the port, ``expected``
    from JAX. The floor ``rtol * max|expected|`` covers elements near zero
    that a sum reaches by cancellation, where the two packages' summation
    orders differ by roundoff on the scale of the summands. Infinities must
    match exactly and do not count toward the scale."""
    actual, expected = to_numpy(actual), to_numpy(expected)
    assert actual.shape == expected.shape, (what, actual.shape,
                                            expected.shape)
    finite = np.abs(expected[np.isfinite(expected)])
    scale = float(finite.max()) if finite.size else 0.0
    np.testing.assert_allclose(actual, expected, rtol=rtol,
                               atol=rtol * scale, err_msg=what)


def assert_states_close(port_state, jax_state, n_slots, rtol, what=""):
    "Every slot's a and b and every carried spectral image."
    for s in range(n_slots):
        for k in ("a", "b"):
            assert_close(port_state[s][k], jax_state[s][k], rtol,
                         what=f"{what} slot {s} {k}")
    if len(jax_state) > n_slots:
        assert set(port_state[n_slots]) == set(jax_state[n_slots])
        for k, v in jax_state[n_slots].items():
            assert_close(port_state[n_slots][k], v, rtol,
                         what=f"{what} spectral cache {k}")


def committee_case(kind, seed=0):
    """(JAX student, port student, teacher sample) of a committee of
    tests/test_models_misc.py:22-45 at N = 40: "soft" (K = 2 relu experts,
    prior means 0.1 and -0.2) or "sgn" (K = 3 sign experts, p_pos 0.6, a
    sign output)."""
    import jax
    from tramp_tpu import models as jmodels
    key = jax.random.PRNGKey(seed)
    if kind == "soft":
        model = jmodels.soft_committee(
            K=2, N=40, alpha=1.5, ensemble_type="gaussian",
            prior_mean=[0.1, -0.2], prior_var=[1.0, 1.0], noise_var=1e-2,
            key=key)
    else:
        model = jmodels.sgn_committee(
            K=3, N=40, alpha=1.0, ensemble_type="gaussian", p_pos=0.6,
            noise_var=1e-2, key=key)
    sample = model.sample(jax.random.PRNGKey(seed + 1))
    j_student = model.to_observed({"y": sample["y"]})
    return j_student, port_model(j_student), sample


def glm_scenario(N=200, prior_rho=0.25, key=3, seed=7, alpha=0.6):
    """The BayesOptimalScenario of a JAX GLM of tests/test_ep_glm.py
    (gauss-Bernoulli prior, Gaussian output of variance 1e-2): by default
    the instance of its adaptive-damping tests (:141-147); its checkpoint
    test's is ``N=80, prior_rho=0.4, key=5, seed=2``."""
    import jax
    from tramp_tpu import glm_generative
    from tramp_tpu.experiments import BayesOptimalScenario
    model = glm_generative(
        N=N, alpha=alpha, ensemble_type="gaussian",
        prior_type="gauss_bernoulli", output_type="gaussian",
        prior_rho=prior_rho, output_var=1e-2, key=jax.random.PRNGKey(key))
    scenario = BayesOptimalScenario(model, x_ids=["x"])
    scenario.setup(seed=seed)
    return scenario

