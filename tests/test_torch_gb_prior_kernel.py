"""The Gauss-Bernoulli prior's laned kernel (tramp_tpu_torch/csrc/gb_prior.cu,
ops/gb_prior.py) on the card. Every test skips where there is no CUDA
device; this file imports no JAX, so it runs on the card with
``python -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_gb_prior_kernel.py``.

- The kernel against the plain version (the eager chain) at the cells'
  shapes, (2048, 4096) and (2048, 10,000), a single 4,096, and ragged rows
  (4,097 and 1), in float32 and float64, posterior and message.
  Tolerances: float64 r and b_new within 1e-13 of the lane's largest
  magnitude, v and a_new within 1e-14 relative. The element arithmetic is
  the eager chain's operation by operation (-fmad=false), so elements differ
  only by the device library's exp and log, and the lane mean by the order
  of its sum (the kernel sums in double in a tree, the eager mean in its
  own order). float32: 1e-5 for all four. The eager mean sums float32
  terms (a relative error up to about log2(n) roundings of 6e-8), the
  kernel doubles; a_new = 1 / v - ax carries v's relative error times
  (1 / v) / a_new, under 3 on these inputs, and b_new that of a_new.
- Lanes: lane i of a launch is lane i launched alone, bit for bit.
- Non-finite input: the same NaN and infinity pattern as the plain version.
- Capture: a CUDA graph's replay gives an eager launch's bits.
- Registers: ptxas reports no spill in any instantiation.
- Libraries: a GLM solve, in a process of its own, loads this kernel's
  library and none of ``pl_fused``'s.
- Solvers: an ``MLVAMPSolver`` and a ``SpectralVAMPSolver`` batch give each
  lane the ``n_iter`` of the eager chain (the route shut) and posteriors
  within 1e-10 of its; each solve counts one launch per loop iteration,
  the GLM one more at its readout.
"""
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import tramp_tpu_torch as tt
from tramp_tpu_torch import config, trace
from tramp_tpu_torch.channels import GaussianChannel, LinearChannel, ReluChannel
from tramp_tpu_torch.ops import _build, gb_prior
from tramp_tpu_torch.parallel import MLVAMPSolver, SpectralVAMPSolver
from tramp_tpu_torch.parallel import with_buffers
from tramp_tpu_torch.priors import GaussBernoulliPrior

F32, F64 = torch.float32, torch.float64
RTOL = {F64: (1e-13, 1e-14), F32: (1e-5, 1e-5)}
#: (lanes, n): the relu batch, the GLM batch, one instance, ragged rows, and
#: long lanes (the kernel takes any length)
SHAPES = [(2048, 4096), (2048, 10_000), (None, 4096), (3, 4097), (None, 4097),
          (3, 1), (None, 1), (3, 50_001), (None, 200_000)]
HYPER = (1.0 / 1.3, 0.1 / 1.3,
         GaussBernoulliPrior(size=1, rho=0.3, mean=0.1, var=1.3).eta)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    torch.backends.cuda.matmul.allow_tf32 = False


def _inputs(lanes, n, dtype, seed=0):
    """(ax, bx) on the card: bx the cavity of a sparse signal, ax 0-d or one
    value per lane in [1, 2)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    kw = dict(dtype=dtype, device="cuda")
    rows = lanes or 1
    x = ((torch.rand(rows, n, generator=g, **kw) < 0.3)
         * torch.randn(rows, n, generator=g, **kw))
    ax = 1.0 + torch.rand(rows, 1, generator=g, **kw)
    bx = ax * x + ax.sqrt() * torch.randn(rows, n, generator=g, **kw)
    if lanes is None:
        return ax.reshape(()), bx.reshape(n)
    return ax, bx


def _close(got, want, dtype, lanes):
    """r / b_new against the lane's largest magnitude, v / a_new
    relative."""
    full, per_lane = got
    full_w, per_lane_w = want
    rtol_full, rtol_lane = RTOL[dtype]
    assert full.shape == full_w.shape and per_lane.shape == per_lane_w.shape
    rows = lanes or 1
    f, fw = full.reshape(rows, -1), full_w.reshape(rows, -1)
    scale = fw.abs().amax(-1, keepdim=True)
    assert bool(((f - fw).abs() <= rtol_full * scale).all())
    assert bool(((per_lane - per_lane_w).abs()
                 <= rtol_lane * per_lane_w.abs()).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [F32, F64])
def test_kernel_matches_plain_on_card(dtype):
    _card()
    for lanes, n in SHAPES:
        ax, bx = _inputs(lanes, n, dtype, seed=n)
        before = (gb_prior.gb_posterior.launches,
                  gb_prior.gb_message.launches)
        r, v = gb_prior.gb_posterior(ax, bx, *HYPER)
        a_new, b_new = gb_prior.gb_message(ax, bx, *HYPER)
        assert (gb_prior.gb_posterior.launches,
                gb_prior.gb_message.launches) == (before[0] + 1,
                                                  before[1] + 1)
        r_w, v_w = gb_prior.gb_posterior_plain(ax, bx, *HYPER)
        a_w, b_w = gb_prior.gb_message_plain(ax, bx, *HYPER)
        torch.cuda.synchronize()
        _close((r, v), (r_w, v_w), dtype, lanes)
        _close((b_new, a_new), (b_w, a_w), dtype, lanes)
        # under 3 where a sum is taken, as the tolerance's reason says
        assert n == 1 or float(((1.0 / v_w) / a_w).abs().max()) < 3.0


@pytest.mark.cuda
def test_hyperparameters_per_lane_on_card():
    _card()
    ax, bx = _inputs(5, 4096, F64, seed=1)
    g = torch.Generator(device="cuda").manual_seed(2)
    kw = dict(dtype=F64, device="cuda")
    prior = GaussBernoulliPrior(
        size=4096, rho=0.1 + 0.5 * torch.rand(5, 1, generator=g, **kw),
        mean=0.1 * torch.randn(5, 1, generator=g, **kw),
        var=0.5 + torch.rand(5, 1, generator=g, **kw))
    hyper = (prior.a, prior.b, prior.eta)
    assert gb_prior.takes(ax, bx, *hyper)
    _close(gb_prior.gb_posterior(ax, bx, *hyper),
           gb_prior.gb_posterior_plain(ax, bx, *hyper), F64, 5)
    _close(gb_prior.gb_message(ax, bx, *hyper)[::-1],
           gb_prior.gb_message_plain(ax, bx, *hyper)[::-1], F64, 5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [F32, F64])
def test_a_lane_has_the_bits_of_its_single_launch_on_card(dtype):
    _card()
    for n in (4096, 4097, 10_000, 50_001):
        ax, bx = _inputs(5, n, dtype, seed=3)
        for fn, order in ((gb_prior.gb_posterior, 1),
                          (gb_prior.gb_message, -1)):
            full, per_lane = fn(ax, bx, *HYPER)[::order]
            for i in range(5):
                one_full, one_lane = fn(ax[i, 0], bx[i], *HYPER)[::order]
                assert torch.equal(full[i], one_full), (fn.__name__, n, i)
                assert torch.equal(per_lane[i, 0], one_lane), (n, i)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [F32, F64])
def test_non_finite_input_gives_the_plain_pattern_on_card(dtype):
    _card()
    ax, bx = _inputs(6, 4096, dtype, seed=4)
    bx[0, 7] = float("nan")
    bx[1, 100] = float("inf")
    bx[2, 4095] = -float("inf")
    ax[3, 0] = float("nan")
    ax[4, 0] = float("inf")
    for fn, plain, order in (
            (gb_prior.gb_posterior, gb_prior.gb_posterior_plain, 1),
            (gb_prior.gb_message, gb_prior.gb_message_plain, -1)):
        got, want = fn(ax, bx, *HYPER), plain(ax, bx, *HYPER)
        for g, w in zip(got, want):
            assert torch.equal(torch.isnan(g), torch.isnan(w)), fn.__name__
            assert torch.equal(torch.isposinf(g), torch.isposinf(w))
            assert torch.equal(torch.isneginf(g), torch.isneginf(w))
        # the lane without a fault is as close as any
        _close([o[5:] for o in got[::order]],
               [o[5:] for o in want[::order]], dtype, 1)


@pytest.mark.cuda
def test_a_captured_launch_replays_the_eager_bits_on_card():
    _card()
    ax, bx = _inputs(64, 4096, F64, seed=5)
    static_ax, static_bx = ax.clone(), bx.clone()
    # first launches eagerly: the build
    gb_prior.gb_posterior(static_ax, static_bx, *HYPER)
    gb_prior.gb_message(static_ax, static_bx, *HYPER)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        post = gb_prior.gb_posterior(static_ax, static_bx, *HYPER)
        msg = gb_prior.gb_message(static_ax, static_bx, *HYPER)
    new_ax, new_bx = _inputs(64, 4096, F64, seed=6)
    static_ax.copy_(new_ax)
    static_bx.copy_(new_bx)
    graph.replay()
    want_post = gb_prior.gb_posterior(new_ax, new_bx, *HYPER)
    want_msg = gb_prior.gb_message(new_ax, new_bx, *HYPER)
    torch.cuda.synchronize()
    for g, w in zip(post + msg, want_post + want_msg):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_ptxas_spills_nothing_on_card():
    _card()
    _, log = gb_prior.build()
    rows = [row for row in _build.ptxas_report(log)
            if row["kernel"].startswith("gb_prior")]
    # posterior and message, 16-byte and single-element loads, two types
    assert len(rows) == 8, log
    assert all(row["spill_bytes"] == 0 for row in rows), rows


@pytest.mark.cuda
def test_a_glm_solve_loads_this_library_alone_on_card():
    _card()
    code = (
        "import torch\n"
        "from test_torch_gb_prior_kernel import _models\n"
        "from tramp_tpu_torch.ops import gb_prior, pl_fused\n"
        "from tramp_tpu_torch.parallel import SpectralVAMPSolver\n"
        "student, model = _models('glm', 4, seed=1)\n"
        "SpectralVAMPSolver(student).solve_info(model)\n"
        "torch.cuda.synchronize()\n"
        "assert gb_prior._fns and not pl_fused._fns\n")
    here = Path(__file__).resolve().parent
    proc = subprocess.run([sys.executable, "-c", code], cwd=here.parent,
                          env={**os.environ,
                               "PYTHONPATH": f"{here}:{here.parent}"},
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


# -- the solvers --------------------------------------------------------------

def _models(kind, lanes, seed):
    """(student, model): the relu net (N = 4096, M = 2048) or the GLM
    (N = 10,000, M = 5,000) on the card in float64, the model with
    ``lanes`` observations."""
    N, M = (4096, 2048) if kind == "relu" else (10_000, 5_000)
    g = torch.Generator(device="cuda").manual_seed(seed)
    kw = dict(dtype=F64, device="cuda")
    W = torch.randn(M, N, generator=g, **kw) / N**0.5
    x = ((torch.rand(lanes, N, generator=g, **kw) < 0.25)
         * torch.randn(lanes, N, generator=g, **kw))
    z = x @ W.T
    chain = GaussBernoulliPrior(size=N, rho=0.25, **kw) @ tt.V(id="x") @ \
        LinearChannel(W, name="W", **kw) @ tt.V(id="z")
    if kind == "relu":
        ys = z.clamp(min=0) + 0.1 * torch.randn(lanes, M, generator=g, **kw)
        chain = chain @ ReluChannel() @ tt.V(id="a")
    else:
        ys = z + 0.1 * torch.randn(lanes, M, generator=g, **kw)
    teacher = (chain @ GaussianChannel(var=1e-2) @ tt.O(id="y")).to_model()
    student = teacher.to_observed({"y": ys[0]})
    return student, with_buffers(student, {(len(student.factors) - 1, "y"):
                                           ys})


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["relu", "glm"])
def test_solvers_keep_each_lane_s_n_iter_on_card(kind, monkeypatch):
    _card()
    monkeypatch.setattr(config, "TRACE", True)
    student, model = _models(kind, 64, seed=7)
    if kind == "relu":
        solver = MLVAMPSolver(student, damping=0.1, tol=1e-6, max_iter=500)
        counter, readout = gb_prior.gb_message, 0
    else:
        solver = SpectralVAMPSolver(student, tol=1e-6, max_iter=200)
        counter, readout = gb_prior.gb_posterior, 1

    def solve(route):
        monkeypatch.setattr(type(solver), "_plans",
                            None if type(solver)._plans is None else {})
        with monkeypatch.context() as patch:
            if not route:
                patch.setattr(gb_prior, "takes", lambda *args: False)
            trace.reset()
            before = counter.launches
            post, n_iter, _ = solver.solve_info(model)
            torch.cuda.synchronize()
            return (post, n_iter, counter.launches - before,
                    trace.summary()["sweep"]["count"])

    post_w, n_iter_w, launches_w, _ = solve(route=False)
    assert launches_w == 0
    post, n_iter, launches, loops = solve(route=True)
    assert torch.equal(n_iter, n_iter_w)
    assert launches == loops + readout and loops == int(n_iter.max())
    for vid, d in post.items():
        r, r_w = d["r"].reshape(64, -1), post_w[vid]["r"].reshape(64, -1)
        scale = r_w.abs().amax(-1, keepdim=True)
        assert bool(((r - r_w).abs() <= 1e-10 * scale).all()), vid
