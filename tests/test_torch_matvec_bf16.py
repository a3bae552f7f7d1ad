"""bfloat16 dense products (``config.MATVEC_BF16``), tramp_tpu_torch against
tramp_tpu on the CPU.

With the switch on, ``LinearChannel._mm`` rounds both operands to bfloat16
and accumulates in float32, and its result is float32 whatever the dtype of
its inputs (tramp_tpu/channels/linear_channel.py:67-84). Each product of two
bfloat16 numbers is exact in float32, so the two packages differ only in
the order of the float32 sums: each element within 1e-5 of the same element
of |A_bf16| @ |x_bf16|, in every layout the port's ``_mm`` takes (one
operator or one per lane, ``(n,)``, ``(n, K)``, ``(B, n)``, ``(B, n, K)``,
both directions), float32 and float64 inputs. The JAX side takes lanes one
by one, the semantics of its ``jax.vmap`` (XLA's CPU runtime refuses some
batched bfloat16 x bfloat16 -> float32 dots). The model axis's split of the
same products is held in tests/test_torch_mesh.py.

Then one EP solve per package of an N = 200 float32 GLM with the switch on:
mean posterior variance within 2e-2 of each other (relative), the bound the
JAX package's bf16 tests hold a bf16 fixed point to
(tests/test_state_bf16.py:48-49).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tramp_tpu as jt
from tramp_tpu import config as jconfig
from tramp_tpu.channels import LinearChannel as JLinear
from tramp_tpu.likelihoods import GaussianLikelihood as JGaussianLikelihood
from tramp_tpu.priors import GaussBernoulliPrior as JGaussBernoulliPrior

import tramp_tpu_torch as tt
from tramp_tpu_torch import config
from tramp_tpu_torch.channels import LinearChannel

from torch_parity import port_model

ROWS, COLS, B, K = 30, 20, 4, 3
TOL = 1e-5
V_RTOL = 2e-2


@pytest.fixture
def bf16(monkeypatch):
    "The switch on in both packages."
    monkeypatch.setattr(config, "MATVEC_BF16", True)
    monkeypatch.setattr(jconfig, "MATVEC_BF16", True)


def _layouts():
    """(name, A shape, x shape, lanes, transpose): every layout of the
    port's ``_mm``."""
    out = []
    for per_lane in (False, True):
        A = (B, ROWS, COLS) if per_lane else (ROWS, COLS)
        for transpose in (False, True):
            n = ROWS if transpose else COLS
            shapes = [((B, n), True), ((B, n, K), True)]
            if not per_lane:
                shapes = [((n,), False), ((n, K), False)] + shapes
            for x, lanes in shapes:
                name = (f"{'per_lane' if per_lane else 'shared'}-x{x}"
                        f"{'-T' if transpose else ''}")
                out.append((name, A, x, lanes, transpose))
    return out


LAYOUTS = _layouts()


def _jax_mm(A, x, lanes, transpose):
    "JAX's ``_mm`` on the same arrays, lane by lane."
    mm = JLinear(np.eye(2))._mm
    if not lanes:
        return np.asarray(mm(jnp.asarray(A), jnp.asarray(x),
                             transpose=transpose))
    return np.stack([
        np.asarray(mm(jnp.asarray(A[b] if A.ndim == 3 else A),
                      jnp.asarray(x[b]), transpose=transpose))
        for b in range(x.shape[0])])


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("name,A_shape,x_shape,lanes,transpose", LAYOUTS,
                         ids=[layout[0] for layout in LAYOUTS])
def test_mm_against_jax(bf16, name, A_shape, x_shape, lanes, transpose,
                        dtype):
    rng = np.random.RandomState(len(name) + len(dtype))
    A = rng.randn(*A_shape).astype(dtype)
    x = rng.randn(*x_shape).astype(dtype)
    got = LinearChannel._mm(torch.as_tensor(A), torch.as_tensor(x),
                            lanes=lanes, transpose=transpose)
    want = _jax_mm(A, x, lanes, transpose)
    assert got.dtype == torch.float32 and want.dtype == np.float32
    assert tuple(got.shape) == want.shape
    bound = LinearChannel._mm(torch.as_tensor(np.abs(A)),
                              torch.as_tensor(np.abs(x)), lanes=lanes,
                              transpose=transpose).numpy()
    err = np.abs(got.numpy().astype(np.float64) - want) / bound
    assert err.max() <= TOL, err.max()


def test_mm_rounds_the_operands_not_the_result(bf16):
    """The product's error against the float64 product is the operands'
    bfloat16 rounding (about 2^-8 of |A| @ |x|), and the result is not
    rounded to bfloat16 after it."""
    rng = np.random.RandomState(0)
    A = torch.as_tensor(rng.randn(ROWS, COLS))
    x = torch.as_tensor(rng.randn(B, COLS))
    got = LinearChannel._mm(A, x, lanes=True)
    exact = x @ A.T
    bound = x.abs() @ A.abs().T
    assert got.dtype == torch.float32
    err = ((got.double() - exact).abs() / bound).max()
    assert 1e-4 < err < 2 ** -7
    widened = x.bfloat16().double() @ A.bfloat16().double().T
    assert torch.allclose(got.double(), widened, rtol=0, atol=1e-6)
    assert not torch.equal(got, got.bfloat16().float())


def test_operator_is_cast_once(bf16):
    """The operator's bfloat16 copy is made at its first product and kept
    while the operator is unchanged; an in-place change makes a new one."""
    A = torch.randn(ROWS, COLS, dtype=torch.float64)
    x = torch.randn(COLS, dtype=torch.float64)
    LinearChannel._mm(A, x, lanes=False)
    kept = A._bf16_copy[1]
    LinearChannel._mm(A, x, lanes=False)
    assert A._bf16_copy[1] is kept
    A.mul_(2.0)
    got = LinearChannel._mm(A, x, lanes=False)
    assert A._bf16_copy[1] is not kept
    assert torch.equal(A._bf16_copy[1], A.bfloat16())
    assert torch.allclose(got.double(), A.bfloat16().double()
                          @ x.bfloat16().double(), rtol=0, atol=1e-5)


def test_switch_off_keeps_the_exact_product():
    "With the switch at its default the product is the working dtype's."
    assert config.matvec_bf16() is False
    A = torch.randn(ROWS, COLS, dtype=torch.float64)
    x = torch.randn(COLS, dtype=torch.float64)
    got = LinearChannel._mm(A, x, lanes=False)
    assert got.dtype == torch.float64 and torch.equal(got, A @ x)
    assert not hasattr(A, "_bf16_copy")


def test_log_partition_and_sample_stay_exact(bf16):
    """The JAX package's log-partition and ``sample`` multiply by W in the
    working dtype, outside ``_mm``: so do the port's."""
    rng = np.random.RandomState(3)
    W = rng.randn(ROWS, COLS)
    ch = LinearChannel(W, device="cpu", dtype=torch.float64)
    Z = torch.as_tensor(rng.randn(COLS))
    assert torch.equal(ch.sample(None, Z), ch.W @ Z)
    az, ax = torch.tensor(1.3, dtype=torch.float64), torch.tensor(
        0.7, dtype=torch.float64)
    bz, bx = torch.as_tensor(rng.randn(COLS)), torch.as_tensor(rng.randn(ROWS))
    jch = JLinear(W)
    want = float(jch.compute_log_partition(*(jnp.asarray(v.numpy())
                                             for v in (az, bz, ax, bx))))
    got = float(ch.compute_log_partition(az, bz, ax, bx))
    # the backward mean inside goes through the bf16 products in both
    assert abs(got - want) <= 1e-5 * abs(want)


def _glm(N=200, alpha=0.6, seed=0):
    rng = np.random.RandomState(seed)
    M = int(alpha * N)
    W = (rng.randn(M, N) / np.sqrt(N)).astype(np.float32)
    x = (rng.randn(N) * (rng.rand(N) < 0.3)).astype(np.float32)
    y = (W @ x + 0.1 * rng.randn(M)).astype(np.float32)
    return (JGaussBernoulliPrior(size=N, rho=0.3) @ jt.V(id="x")
            @ JLinear(jnp.asarray(W)) @ jt.V(id="z")
            @ JGaussianLikelihood(y=jnp.asarray(y), var=1e-2)).to_model()


def test_ep_solve_against_jax(bf16):
    """An N = 200 float32 GLM solved by each package's engine with the
    switch on: the mean posterior variances within 2e-2 of each other, and
    of the exact products' fixed point."""
    with jax.enable_x64(False):
        jmodel = _glm()
        jep = jt.ExpectationPropagation(jmodel)
        jep.iterate(max_iter=200, damping=0.1)
        v_jax = float(jnp.mean(jep.get_variable_data("x")["v"]))
        model = port_model(jmodel, dtype=torch.float32)
    ep = tt.ExpectationPropagation(model).iterate(max_iter=200, damping=0.1)
    x = ep.get_variable_data("x")
    assert x["r"].dtype == torch.float32 and torch.isfinite(x["r"]).all()
    v = float(x["v"].mean())
    assert abs(v - v_jax) / v_jax < V_RTOL, (v, v_jax)
    config.MATVEC_BF16 = False
    try:
        exact = tt.ExpectationPropagation(model).iterate(max_iter=200,
                                                         damping=0.1)
    finally:
        config.MATVEC_BF16 = True
    v_exact = float(exact.get_variable_data("x")["v"].mean())
    assert abs(v - v_exact) / v_exact < V_RTOL
