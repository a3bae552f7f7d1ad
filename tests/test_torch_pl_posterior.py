"""The plain twin of the fused piecewise-linear posterior,
tramp_tpu_torch against tramp_tpu, float64 on the CPU.

Tolerance: ``pl_posterior_plain`` against the JAX Pallas kernel run in
interpret mode and against its jnp twin ``pl_posterior_reference``, rtol
1e-10 on all five streams, the tolerance of tests/test_pallas_ops.py:38-42
(the interpret-mode kernel uses Chebyshev forms of erfcx, erf and erfc).
torch_parity.assert_close is relative to each element, with a floor of
rtol times the array's largest finite magnitude.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from tramp_tpu.channels import (
    SgnChannel, AbsChannel, ReluChannel, LeakyReluChannel, HardTanhChannel,
    SymmetricDoorChannel,
)
from tramp_tpu.ops import fused_pl_posterior, pl_posterior_reference

from tramp_tpu_torch.ops import pl_posterior_plain

from torch_parity import assert_close

CHANNELS = [
    SgnChannel(), AbsChannel(), ReluChannel(), LeakyReluChannel(slope=0.3),
    HardTanhChannel(), SymmetricDoorChannel(width=0.7),
]
STREAMS = ("rz", "vz", "rx", "vx", "logZ")


def _jax_kernel(az, bz, ax, bx, specs):
    return fused_pl_posterior(az, bz, ax, bx, specs, interpret=True)


@pytest.mark.parametrize("oracle", [_jax_kernel, pl_posterior_reference],
                         ids=["pallas_interpret", "jnp_reference"])
@pytest.mark.parametrize("channel", CHANNELS, ids=lambda c: c.name)
def test_plain_matches_jax(channel, oracle):
    rng = np.random.RandomState(0)
    n = 300  # not a multiple of 128: the JAX kernel pads
    az, ax = 1.7, 0.9
    bz, bx = rng.randn(n) * 2, rng.randn(n) * 2
    want = oracle(az, jnp.asarray(bz), ax, jnp.asarray(bx),
                  channel.region_specs)
    got = pl_posterior_plain(
        torch.tensor(az, dtype=torch.float64), torch.as_tensor(bz),
        torch.tensor(ax, dtype=torch.float64), torch.as_tensor(bx),
        channel.region_specs)
    for name, g, w in zip(STREAMS, got, want):
        assert_close(g, w, 1e-10, what=name)


@pytest.mark.parametrize("oracle", [_jax_kernel, pl_posterior_reference],
                         ids=["pallas_interpret", "jnp_reference"])
@pytest.mark.parametrize("channel", CHANNELS[2:5], ids=lambda c: c.name)
def test_plain_with_lanes_matches_vmapped_jax(channel, oracle):
    """(B, n) inputs with a precision per lane, (B, 1), against ``jax.vmap``
    of the JAX kernel (interpret mode) and of its jnp twin: rtol 1e-10."""
    import jax
    rng = np.random.RandomState(1)
    lanes, n = 3, 300
    az, ax = 1.2 + rng.rand(lanes), 0.4 + rng.rand(lanes)
    bz, bx = rng.randn(lanes, n) * 2, rng.randn(lanes, n) * 2
    want = jax.vmap(lambda a, b, c, d: oracle(a, b, c, d,
                                              channel.region_specs))(
        *map(jnp.asarray, (az, bz, ax, bx)))
    got = pl_posterior_plain(
        torch.as_tensor(az).reshape(lanes, 1), torch.as_tensor(bz),
        torch.as_tensor(ax).reshape(lanes, 1), torch.as_tensor(bx),
        channel.region_specs)
    for name, g, w in zip(STREAMS, got, want):
        assert g.shape == (lanes, n)
        assert_close(g, w, 1e-10, what=name)
