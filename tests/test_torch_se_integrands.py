"""The elementwise integrands of the piecewise-linear channels' state
evolution (``scalar_forward_variance``, ``scalar_backward_variance``,
``scalar_log_partition``), tramp_tpu_torch against tramp_tpu, float64 on the
CPU. In the port they are outputs of the five-output posterior
(``pl_posterior_plain`` on the CPU); the JAX package computes them region by
region and merges them (``_merge_elementwise``). Tolerance: rtol 1e-10, the
tolerance of tests/test_pallas_ops.py:38-42 (torch_parity.assert_close:
relative to each element, with a floor of rtol times the array's largest
finite magnitude).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tramp_tpu.channels import (
    AbsChannel, ReluChannel, LeakyReluChannel, HardTanhChannel,
    SymmetricDoorChannel,
)

from tramp_tpu_torch import channels as port_channels

from torch_parity import assert_close

CHANNELS = [
    AbsChannel(), ReluChannel(), LeakyReluChannel(slope=0.3),
    HardTanhChannel(), SymmetricDoorChannel(width=0.7),
]


@pytest.mark.parametrize("channel", CHANNELS, ids=lambda c: c.name)
def test_scalar_integrands_match_the_elementwise_merge(channel):
    """The three scalar_* integrands of the state evolution against the JAX
    package's _merge_elementwise path, elementwise on a grid of (bz, bx),
    also at ax = 0; and the log-partition that sums one of them."""
    port = getattr(port_channels, type(channel).__name__)(
        **{f: getattr(channel, f) for f in ("slope", "width")
           if f in type(channel)._meta_fields})
    assert port.region_specs == channel.region_specs

    def _t(x):
        return torch.as_tensor(x, dtype=torch.float64)

    rng = np.random.RandomState(7)
    bz, bx = 3 * rng.randn(30, 20), 3 * rng.randn(30, 20)
    for az, ax in ((1.7, 0.9), (0.8, 0.0)):
        for method in ("scalar_forward_variance", "scalar_backward_variance",
                       "scalar_log_partition"):
            got = getattr(port, method)(_t(az), _t(bz), _t(ax), _t(bx))
            want = getattr(channel, method)(az, jnp.asarray(bz), ax,
                                            jnp.asarray(bx))
            assert_close(got, want, 1e-10, what=f"{method} az={az} ax={ax}")
    assert_close(port.compute_log_partition(_t(1.7), _t(bz[0]), _t(0.9),
                                            _t(bx[0])),
                 channel.compute_log_partition(1.7, jnp.asarray(bz[0]), 0.9,
                                               jnp.asarray(bx[0])), 1e-10)
