"""Shared helpers of the tramp_tpu_torch parity tests: the exporter that
turns a tramp_tpu Model and its engine state into the numpy description
that tramp_tpu_torch.convert reads, and the comparison helper.

Both packages get identical float64 inputs: JAX runs with x64
(tests/conftest.py), the port in torch.float64 on the CPU.
"""
import numpy as np
import torch

from tramp_tpu.base import Variable


def _np(x):
    return None if x is None else np.asarray(x)


def describe_factor(factor):
    "The convert.factor_from_description dict of a tramp_tpu factor."
    cls = type(factor)
    return {"class": cls.__name__,
            "data": {f: _np(getattr(factor, f)) for f in cls._data_fields},
            "meta": {f: getattr(factor, f) for f in cls._meta_fields}}


def describe_model(model):
    "The convert.model_from_description dict of a tramp_tpu Model."
    dag = model.model_dag.dag
    nodes = dag.nodes
    index = {n: i for i, n in enumerate(nodes)}
    out = [{"class": type(n).__name__, "id": n.id}
           if isinstance(n, Variable) else describe_factor(n)
           for n in nodes]
    return {"nodes": out,
            "edges": [(index[u], index[v]) for u, v in dag.edges]}


def describe_state(state, n_slots):
    "(slots, cache) of a tramp_tpu engine state, as numpy."
    slots = [{k: np.asarray(v) for k, v in msg.items()}
             for msg in state[:n_slots]]
    cache = None
    if len(state) > n_slots:
        cache = {k: np.asarray(v) for k, v in state[n_slots].items()}
    return slots, cache


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
