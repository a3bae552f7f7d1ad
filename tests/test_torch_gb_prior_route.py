"""The Gauss-Bernoulli prior's route to its laned kernel
(tramp_tpu_torch/ops/gb_prior.py), on the CPU.

- The plain posterior and message equal the eager chain the prior ran
  before the kernel (``_eager_posterior``, written here as it was), bit for
  bit: with lanes and for one instance, with hyperparameters shared and
  per lane, in float32 and float64; so do the prior's own methods, which
  take the plain versions off the card.
- The route: an isotropic prior goes to the wrappers wherever the kernel
  takes the inputs, a lane of any length; a prior with per-element
  variances stays on its eager chain, and a precision per element or an
  input of another type than bx's takes the plain versions.
- The wrappers count no launch on the CPU, and their counters are in the
  solver loop's ``COUNTERS``, which a plan's replays advance.
The kernel against the plain versions is tests/test_torch_gb_prior_kernel.py,
on the card.
"""
import pytest
import torch

from tramp_tpu_torch.base import compute_ab_new
from tramp_tpu_torch.beliefs import sparse
from tramp_tpu_torch.lanes import lane_mean
from tramp_tpu_torch.ops import _build, gb_prior
from tramp_tpu_torch.parallel import loop
from tramp_tpu_torch.priors import GaussBernoulliPrior

N = 203  # no multiple of 4
LANES = 3


def _eager_posterior(prior, ax, bx):
    """GaussBernoulliPrior.compute_forward_posterior as it was before the
    route to the kernel."""
    a = ax + prior.a
    b = bx + prior.b
    eta = prior.eta
    rx = sparse.r(a, b, eta)
    vx = sparse.v(a, b, eta)
    if prior.isotropic:
        vx = lane_mean(vx, ax)
    return rx, vx


def _eager_message(prior, ax, bx):
    "Prior.compute_forward_message on the eager posterior."
    rx, vx = _eager_posterior(prior, ax, bx)
    return compute_ab_new(rx, vx, ax, bx)


def _case(lanes, per_lane, dtype, n=N, seed=0):
    """(prior, ax, bx): ax 0-d or one value per lane; rho, mean and var
    Python numbers or one value per lane."""
    g = torch.Generator().manual_seed(seed)
    kw = dict(dtype=dtype, device="cpu")
    shape = (n,) if lanes is None else (lanes, n)
    bx = 2.0 * torch.randn(shape, generator=g, **kw)
    if lanes is None:
        ax = torch.tensor(1.7, **kw)
    else:
        ax = 1.0 + torch.rand((lanes, 1), generator=g, **kw)
    if per_lane:
        rho = 0.1 + 0.5 * torch.rand((lanes, 1), generator=g, **kw)
        mean = 0.2 * torch.randn((lanes, 1), generator=g, **kw)
        var = 0.5 + torch.rand((lanes, 1), generator=g, **kw)
    else:
        rho, mean, var = 0.3, 0.1, 1.3
    prior = GaussBernoulliPrior(size=n, rho=rho, mean=mean, var=var,
                                device="cpu", dtype=dtype)
    return prior, ax, bx


CASES = [(None, False), (LANES, False), (LANES, True)]


def _same_bits(got, want):
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert torch.equal(g, w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("lanes, per_lane", CASES)
def test_plain_versions_keep_the_eager_bits(lanes, per_lane, dtype):
    prior, ax, bx = _case(lanes, per_lane, dtype)
    hyper = (prior.a, prior.b, prior.eta)
    assert gb_prior.takes(ax, bx, *hyper)
    want_post = _eager_posterior(prior, ax, bx)
    want_msg = _eager_message(prior, ax, bx)
    _same_bits(gb_prior.gb_posterior_plain(ax, bx, *hyper), want_post)
    _same_bits(gb_prior.gb_message_plain(ax, bx, *hyper), want_msg)
    # the wrappers and the prior's methods take the plain versions here
    _same_bits(gb_prior.gb_posterior(ax, bx, *hyper), want_post)
    _same_bits(gb_prior.gb_message(ax, bx, *hyper), want_msg)
    _same_bits(prior.compute_forward_posterior(ax, bx), want_post)
    _same_bits(prior.compute_forward_message(ax, bx), want_msg)


@pytest.mark.parametrize("lanes", [None, LANES])
def test_meta_tensors_take_the_plain_shapes(lanes):
    prior, ax, bx = _case(lanes, False, torch.float64)
    ax_m, bx_m = ax.to("meta"), bx.to("meta")
    for got, want in ((prior.compute_forward_posterior(ax_m, bx_m),
                       _eager_posterior(prior, ax, bx)),
                      (prior.compute_forward_message(ax_m, bx_m),
                       _eager_message(prior, ax, bx))):
        assert [g.shape for g in got] == [w.shape for w in want]
        assert all(g.device.type == "meta" for g in got)


def _counting(monkeypatch):
    "Calls of the two wrappers, by name, with the wrappers still working."
    calls = []
    for name in ("gb_posterior", "gb_message"):
        fn = getattr(gb_prior, name)

        def wrapped(*args, fn=fn, name=name):
            calls.append(name)
            return fn(*args)
        monkeypatch.setattr(gb_prior, name, wrapped)
    return calls


def test_the_route_takes_an_isotropic_lane_within_the_limit(monkeypatch):
    calls = _counting(monkeypatch)
    for lanes, per_lane in CASES:
        prior, ax, bx = _case(lanes, per_lane, torch.float64)
        prior.compute_forward_posterior(ax, bx)
        prior.compute_forward_message(ax, bx)
    # a long lane: the kernel takes any length
    prior, ax, bx = _case(2, False, torch.float64, n=50_001)
    prior.compute_forward_message(ax, bx)
    assert calls == ["gb_posterior", "gb_message"] * len(CASES) + [
        "gb_message"]


@pytest.mark.parametrize("case", ["per_element_v", "ax_other_dtype",
                                  "per_element_ax", "other_dtype"])
def test_the_route_leaves_the_rest_eager(case, monkeypatch):
    """A prior with per-element variances (not isotropic), a precision of
    another type than bx's, a precision per element and a hyperparameter of
    another type than bx's take today's eager chain, as they did: the
    prior's own or the plain versions, never the wrappers."""
    prior, ax, bx = _case(LANES, case == "other_dtype", torch.float64)
    if case == "per_element_v":
        prior.isotropic = False
    elif case == "ax_other_dtype":
        ax = ax.float()
    elif case == "per_element_ax":
        ax = ax.expand(bx.shape).contiguous()
    elif case == "other_dtype":
        prior.var = prior.var.float()
    calls = _counting(monkeypatch)
    _same_bits(prior.compute_forward_posterior(ax, bx),
               _eager_posterior(prior, ax, bx))
    _same_bits(prior.compute_forward_message(ax, bx),
               _eager_message(prior, ax, bx))
    assert calls == []
    # the prior's isotropy is its own test; the rest is the kernel's
    assert gb_prior.takes(ax, bx, prior.a, prior.b, prior.eta) == (
        case == "per_element_v")


def test_the_counters_do_not_move_on_the_cpu():
    before = (gb_prior.gb_posterior.launches, gb_prior.gb_message.launches)
    for per_lane in (True, False):
        prior, ax, bx = _case(LANES, per_lane, torch.float64)
        prior.compute_forward_posterior(ax, bx)
        prior.compute_forward_message(ax, bx)
    # the shape sweep's meta tensors (hyperparameters that are numbers)
    prior.compute_forward_message(ax.to("meta"), bx.to("meta"))
    assert (gb_prior.gb_posterior.launches,
            gb_prior.gb_message.launches) == before


def test_the_counters_are_in_the_loop_s_counters():
    assert (gb_prior.gb_posterior, "launches") in loop.COUNTERS
    assert (gb_prior.gb_message, "launches") in loop.COUNTERS


def test_the_wrappers_refuse_bfloat16():
    prior, ax, bx = _case(None, False, torch.float64)
    for fn in (gb_prior.gb_posterior, gb_prior.gb_message):
        with pytest.raises(ValueError, match="bfloat16"):
            fn(ax, bx.bfloat16(), prior.a, prior.b, prior.eta)


def test_ptxas_report_reads_the_prior_kernels():
    "The report takes any kernel whose name ends in _kernel, these two too."
    log = (
        "ptxas info    : Compiling entry function '_ZN55_GLOBAL__N__7e2c"
        "25gb_prior_posterior_kernelIdLi2EEEvPKT_lS3_' for 'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 64 registers, used 1 barriers\n"
        "ptxas info    : Compiling entry function '_ZN55_GLOBAL__N__7e2c"
        "23gb_prior_message_kernelIfLi1EEEvPKT_lS3_' for 'sm_90a'\n"
        "    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads\n"
        "ptxas info    : Used 35 registers, used 1 barriers\n")
    assert _build.ptxas_report(log) == [
        {"kernel": "gb_prior_posterior_kernel", "dtype": "d", "params": [2],
         "registers": 64, "spill_bytes": 0},
        {"kernel": "gb_prior_message_kernel", "dtype": "f", "params": [1],
         "registers": 35, "spill_bytes": 4}]
