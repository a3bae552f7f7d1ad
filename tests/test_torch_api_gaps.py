"""Public methods of the JAX package that the port gained last, held against
tramp_tpu on the same numpy inputs, float64 on the CPU:
``LinearChannel.compute_forward_mean`` / ``compute_backward_mean``
(tramp_tpu/channels/linear_channel.py:97,141) and
``PiecewiseLinearChannel.merge_estimates`` (piecewise_linear_channel.py:61)
at rtol 1e-10 (``torch_parity.assert_close``), ``Likelihood.get_size``
(likelihoods/base_likelihood.py:12) equal, ``DiGraph.copy``
(models/graph.py:64) equal nodes and edges, and
``MarchenkoPasturChannel.sample`` (channels/analytical_linear_channel.py:83)
by its shape and its distribution, with the port's explicit generator (the
two packages' generators differ): F @ Z with F of variance 1 / N per
entry, so each output element of a fixed Z is N(0, |Z|^2 / N).
The config names ``default_dtype``, ``GH_NODES`` and ``GL_NODES`` are held
too.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tramp_tpu import config as jconfig
from tramp_tpu.channels import LinearChannel as JLinear
from tramp_tpu.channels import ReluChannel as JRelu
from tramp_tpu.channels.analytical_linear_channel import (
    MarchenkoPasturChannel as JMarchenkoPastur)
from tramp_tpu.likelihoods import GaussianLikelihood as JGaussianLikelihood
from tramp_tpu.models.graph import DiGraph as JDiGraph

from tramp_tpu_torch import config, convert
from tramp_tpu_torch.channels import ReluChannel
from tramp_tpu_torch.channels.analytical_linear_channel import (
    MarchenkoPasturChannel)
from tramp_tpu_torch.likelihoods import GaussianLikelihood
from tramp_tpu_torch.models.graph import DiGraph
from tramp_tpu_torch.utils import integration

from torch_parity import assert_close, describe_factor

F64 = torch.float64


def _t(x):
    return torch.as_tensor(np.asarray(x), dtype=F64)


@pytest.mark.parametrize("shape", [(30, 20), (20, 30), (24, 24)])
@pytest.mark.parametrize("K", [None, 3])
def test_linear_channel_means(shape, K):
    "Both means, with the JAX package's SVD, (n,) and (n, K) variables."
    rng = np.random.RandomState(sum(shape) + (K or 0))
    jch = JLinear(rng.randn(*shape) / np.sqrt(shape[1]))
    ch = convert.factor_from_description(describe_factor(jch), device="cpu",
                                         dtype=F64)
    tail = () if K is None else (K,)
    bz = rng.randn(shape[1], *tail)
    bx = rng.randn(shape[0], *tail)
    az, ax = 1.7, 0.4
    args = (az, jnp.asarray(bz), ax, jnp.asarray(bx))
    targs = (_t(az), _t(bz), _t(ax), _t(bx))
    assert_close(ch.compute_forward_mean(*targs),
                 jch.compute_forward_mean(*args), 1e-10)
    assert_close(ch.compute_backward_mean(*targs),
                 jch.compute_backward_mean(*args), 1e-10)
    assert torch.equal(ch.compute_forward_mean(*targs),
                       ch.compute_forward_posterior(*targs)[0])


@pytest.mark.parametrize("n", [1, 64])
def test_merge_estimates(n):
    "The regions' moments merged by the softmax of their log-partitions."
    rng = np.random.RandomState(n)
    rs, vs, As = ([rng.randn(n) for _ in range(3)],
                  [rng.rand(n) + 0.1 for _ in range(3)],
                  [3 * rng.randn(n) for _ in range(3)])
    want = JRelu().merge_estimates(*([jnp.asarray(x) for x in xs]
                                     for xs in (rs, vs, As)))
    got = ReluChannel().merge_estimates(*([_t(x) for x in xs]
                                          for xs in (rs, vs, As)))
    for g, w in zip(got, want):
        assert_close(g, w, 1e-10)
    assert got[1].ndim == 0


@pytest.mark.parametrize("y", [None, np.zeros(7), np.zeros((3, 4)),
                               np.zeros((2, 3, 4))],
                         ids=["none", "vector", "matrix", "tensor"])
def test_likelihood_get_size(y):
    want = JGaussianLikelihood(y=None, var=1.0).get_size(
        None if y is None else jnp.asarray(y))
    got = GaussianLikelihood(y=None, var=1.0).get_size(
        None if y is None else _t(y))
    assert got == want


def test_digraph_copy():
    edges = [("a", "b"), ("b", "c"), ("a", "d"), ("d", "c")]
    graphs = []
    for cls in (JDiGraph, DiGraph):
        g = cls()
        g.add_node("e")
        for u, v in edges:
            g.add_edge(u, v)
        graphs.append((g, g.copy()))
    (jg, jc), (g, c) = graphs
    assert c is not g and c.nodes == jc.nodes == g.nodes
    assert c.edges == jc.edges == g.edges
    assert c.topological_sort() == jc.topological_sort()
    c.add_edge("c", "f")
    assert "f" not in g.nodes


def test_marchenko_pastur_sample():
    """(alpha N,) out of (N,) for alpha 0.5 and 2 in both packages; each
    element of F @ Z over 400 draws is N(0, |Z|^2 / N): its mean within 4
    standard errors of 0 and its variance within 15% of |Z|^2 / N."""
    N = 50
    Z = torch.as_tensor(np.random.RandomState(0).randn(N), dtype=F64)
    g = torch.Generator().manual_seed(0)
    import jax
    for alpha in (0.5, 2.0):
        ch = MarchenkoPasturChannel(alpha=alpha)
        jout = JMarchenkoPastur(alpha=alpha).sample(
            jax.random.PRNGKey(0), jnp.asarray(Z.numpy()))
        draws = torch.stack([ch.sample(g, Z) for _ in range(400)])
        assert draws.shape == (400, int(alpha * N)) == (400,) + jout.shape
        assert draws.dtype == F64
        var = float(Z @ Z) / N
        assert float(draws.mean(0).abs().max()) < 4 * np.sqrt(var / 400)
        assert np.allclose(draws.var(0).mean().item(), var, rtol=0.15)


def test_config_names():
    "The JAX package's config names that the port now has."
    assert config.default_dtype() == config.DEFAULT_DTYPE == torch.float32
    assert config.GH_NODES == jconfig.GH_NODES == integration.GH_NODES
    assert config.GL_NODES == jconfig.GL_NODES == integration.GL_NODES
    assert config.matvec_bf16() is False and config.state_bf16() is False
    assert config.pin_constant_messages() is False
    assert config.spectral_carry() is True


def test_spectral_carry_switch(monkeypatch):
    """``config.SPECTRAL_CARRY = False``, read when the engine is built:
    no carried image, and the trajectory of the carried engine bit for bit
    (tests/test_spectral_carry.py's contract)."""
    import tramp_tpu_torch as tt
    from tramp_tpu_torch.likelihoods import GaussianLikelihood
    from tramp_tpu_torch.priors import GaussBernoulliPrior
    from tramp_tpu_torch.channels import LinearChannel
    rng = np.random.RandomState(0)
    W = rng.randn(28, 40) / np.sqrt(40)
    y = W @ ((rng.rand(40) < 0.3) * rng.randn(40)) + 0.1 * rng.randn(28)
    kw = dict(device="cpu", dtype=F64)
    model = (GaussBernoulliPrior(size=40, rho=0.3, **kw) @ tt.V(id="x")
             @ LinearChannel(W, **kw) @ tt.V(id="z")
             @ GaussianLikelihood(y=_t(y), var=1e-2)).to_model()
    carried = tt.ExpectationPropagation(model).iterate(max_iter=50,
                                                       damping=0.1)
    monkeypatch.setattr(config, "SPECTRAL_CARRY", False)
    plain = tt.ExpectationPropagation(model)
    assert carried.spectral_factors == (2,) and plain.spectral_factors == ()
    plain.iterate(max_iter=50, damping=0.1)
    assert plain.n_iter == carried.n_iter
    assert torch.equal(plain.get_variable_data("x")["r"],
                       carried.get_variable_data("x")["r"])
