"""Guards of the port's boundaries: tramp_tpu_torch imports neither JAX nor
the JAX package; the piecewise-linear wrapper takes its plain version for
CPU tensors and a shape rule for meta tensors; its module imports without
nvcc or a GPU (the kernel is built at first launch); and, on a card, the
kernel agrees with its plain version.

This file imports no JAX, so the card-only test runs on a machine without
it: ``python -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_port_guards.py``.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tramp_tpu_torch.channels import (
    SgnChannel, AbsChannel, ReluChannel, LeakyReluChannel, HardTanhChannel,
    SymmetricDoorChannel,
)
from tramp_tpu_torch.ops import pl_fused

REPO = Path(__file__).resolve().parents[1]
CHANNELS = [
    SgnChannel(), AbsChannel(), ReluChannel(), LeakyReluChannel(slope=0.3),
    HardTanhChannel(), SymmetricDoorChannel(width=0.7),
]


def _run(code, env=None):
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)


def test_port_imports_no_jax():
    code = ("import sys, tramp_tpu_torch, tramp_tpu_torch.convert; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib')) or m == 'tramp_tpu' or "
            "m.startswith('tramp_tpu.')]; "
            "assert not bad, bad")
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr


def test_port_sources_import_no_jax():
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|jaxlib|tramp_tpu)(\.|\s|$)", re.M)
    sources = sorted((REPO / "tramp_tpu_torch").rglob("*.py"))
    sources.append(REPO / "chip_smoke.py")
    offenders = [str(p) for p in sources if pattern.search(p.read_text())]
    assert len(sources) > 10 and not offenders, offenders


def _inputs(n, dtype, device="cpu", seed=0):
    rng = np.random.RandomState(seed)
    bz = torch.as_tensor(2 * rng.randn(n), dtype=dtype, device=device)
    bx = torch.as_tensor(2 * rng.randn(n), dtype=dtype, device=device)
    az = torch.tensor(1.7, dtype=dtype, device=device)
    ax = torch.tensor(0.9, dtype=dtype, device=device)
    return az, bz, ax, bx


def test_wrapper_uses_plain_version_on_cpu():
    az, bz, ax, bx = _inputs(257, torch.float64)
    before = pl_fused.pl_posterior.launches
    for channel in CHANNELS:
        got = pl_fused.pl_posterior(az, bz, ax, bx, channel.region_specs)
        want = pl_fused.pl_posterior_plain(az, bz, ax, bx,
                                           channel.region_specs)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert pl_fused.pl_posterior.launches == before


def test_wrapper_shape_rule_on_meta():
    az, bz, ax, bx = (t.to("meta") for t in _inputs(300, torch.float32))
    outs = pl_fused.pl_posterior(az, bz, ax, bx, ReluChannel().region_specs)
    assert len(outs) == 5
    assert all(o.device.type == "meta" and o.shape == bz.shape
               and o.dtype == torch.float32 for o in outs)


def test_kernel_module_imports_without_nvcc_or_gpu():
    env = dict(os.environ, PATH="/usr/bin:/bin", CUDA_VISIBLE_DEVICES="")
    code = ("import shutil, torch; "
            "from tramp_tpu_torch.ops import pl_fused; "
            "assert shutil.which('nvcc') is None; "
            "assert not torch.cuda.is_available(); "
            "assert pl_fused._lib is None")
    proc = _run(code, env=env)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    """Kernel vs plain version on the card: rtol 1e-10 in float64 (the JAX
    package's Pallas tolerance) and 1e-4 in float32, relative to each
    element with a floor of rtol times the stream's largest magnitude."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    for dtype, rtol in ((torch.float64, 1e-10), (torch.float32, 1e-4)):
        for n in (1, 2048, 100_003):
            az, bz, ax, bx = _inputs(n, dtype, device="cuda", seed=n)
            for channel in CHANNELS:
                before = pl_fused.pl_posterior.launches
                got = pl_fused.pl_posterior(az, bz, ax, bx,
                                            channel.region_specs)
                assert pl_fused.pl_posterior.launches == before + 1
                want = pl_fused.pl_posterior_plain(az, bz, ax, bx,
                                                   channel.region_specs)
                torch.cuda.synchronize()
                for g, w in zip(got, want):
                    bound = rtol * (w.abs() + w.abs().max())
                    assert bool(((g - w).abs() <= bound).all()), (
                        channel.name, dtype, n)
