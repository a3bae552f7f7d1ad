"""tramp_tpu_torch.graft_entry, the root entry points, against the JAX
package's root module __graft_entry__.py (imported as
tests/test_parallel.py:104-111 does), float64 on the CPU:

- ``entry``'s ``fn`` on the JAX ``entry()`` instance and state, carried
  over by tests/torch_parity.py, against ``jax.jit`` of the JAX ``fn``:
  every message and the carried spectral image at rtol 1e-11 (the
  tolerance of one sweep, tests/test_torch_ep_slice.py:9), from the initial
  state and from the swept one;
- the port's own ``entry(device="cpu")``: ``fn`` applied twice has the bits
  of two sweeps of ``ExpectationPropagation.iterate``;
- ``dryrun_multichip``'s stages in gloo worlds of 1, 2 and 4 processes
  (tests/torch_mesh_worker.py, scenario ``graft``), launched by a module
  fixture while this process runs the JAX side: stage 2 on a (2, 2) mesh on
  the JAX instances of ``PRNGKey(7)`` against the JAX package's
  ``EPSolver.solve_batch`` of the same instances (r and v at rtol 1e-6, equal
  n_iter, __graft_entry__.py:189-195); stage 4 on (1, 2) and (1, 4), and
  its solve on (1, 2) on the JAX package's own stage-4 instance against the
  JAX package's solve of it (the same rtol and n_iter); stage 3 on (2,) and
  (4,); the whole dryrun in a world of one.

Stage 4 runs at N = 1536 here (``torch_mesh_worker.STAGE4_N``), not its
4096: at 4096 the host SVD alone takes about 10 s on one thread of a
CPU core, over this file's budget, so the world of one runs the dryrun's
stages 1-3 whole and stage 4 at 1536. Its finite-N band (v within 0.1, the
MSE within 0.25 of v_SE) is a statement about one instance: the port's
instance of N = 1536 meets it, the JAX package's misses it in both
packages alike.
"""
import pickle
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import tramp_tpu as jt
from tramp_tpu import channels as jchannels
from tramp_tpu import parallel as jparallel
from tramp_tpu.priors import GaussBernoulliPrior as JGaussBernoulliPrior

from tramp_tpu_torch import convert, graft_entry
from tramp_tpu_torch.algos import ExpectationPropagation

import torch_mesh_worker as worker
from torch_parity import (
    assert_states_close, describe_model, describe_state, port_model,
)

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import __graft_entry__ as jge  # noqa: E402  (the JAX package's entry points)

WORLDS = (1, 2, 4)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The worlds' results and the JAX side, computed while they run:
    ``worlds`` ({world: [rank results]}), ``stage2`` (({"r", "v"}, n_iter)
    of the JAX package's ``EPSolver.solve_batch`` on the two instances of
    ``PRNGKey(7)``) and ``entry`` (the JAX ``entry()`` student, and its
    initial state with the two states that ``jax.jit(fn)`` sweeps from
    it)."""
    keys = jax.random.split(jax.random.PRNGKey(7), 2)
    models = [jge._build_glm(N=1024, alpha=0.5, key=k) for k in keys]
    student4, x4 = _jax_stage4_instance(worker.STAGE4_N)
    dirs, waits = {}, {}
    for world in WORLDS:
        dirs[world] = tmp_path_factory.mktemp(f"graft{world}")
        with open(dirs[world] / "models.pkl", "wb") as f:
            pickle.dump([describe_model(m) for m in models], f)
        if world == 2:
            with open(dirs[world] / "stage4.pkl", "wb") as f:
                pickle.dump((describe_model(student4), x4), f)
        waits[world] = worker.launch("graft", world, dirs[world])
    solver4 = jparallel.EPSolver(student4, damping=0.1, max_iter=200,
                                 tol=1e-7)
    post, n_iter = solver4.solve_batch(jparallel.stack_pytrees([student4]))
    stage4 = ({k: np.asarray(post["x"][k][0]) for k in ("r", "v")},
              int(n_iter[0]))
    solver = jparallel.EPSolver(models[0], damping=0.1, max_iter=200,
                                tol=1e-8)
    post, n_iter = solver.solve_batch(jparallel.stack_pytrees(models))
    stage2 = ({k: np.asarray(post["x"][k]) for k in ("r", "v")},
              np.asarray(n_iter))
    jfn, (student, state) = jge.entry()
    jitted = jax.jit(jfn)
    states = [state]
    for _ in range(2):
        states.append(jitted(student, states[-1]))
    for wait in waits.values():
        wait()
    return dict(worlds={w: worker.results(d, w) for w, d in dirs.items()},
                stage2=stage2, stage4=stage4, entry=(student, states))


def _jax_stage4_instance(N, alpha=0.5, rho=0.25, noise_var=1e-2):
    """The instance of the JAX ``_dryrun_model_parallel``
    (__graft_entry__.py:65-88) at ``N``: ``RandomState(0)``'s W, its full
    host SVD, the teacher sampled from ``PRNGKey(2)``. Returns (the student,
    the teacher's x)."""
    M = int(alpha * N)
    W = np.random.RandomState(0).randn(M, N) / np.sqrt(N)
    U, s, Vt = np.linalg.svd(W, full_matrices=True)
    linear = jchannels.LinearChannel(jnp.asarray(W), svd=(
        jnp.asarray(U), jnp.asarray(s), jnp.asarray(Vt)), name="W")
    teacher = (JGaussBernoulliPrior(size=N, rho=rho) @ jt.V(id="x") @
               linear @ jt.V(id="z") @
               jchannels.GaussianChannel(var=noise_var) @ jt.O(id="y")
               ).to_model()
    sample = teacher.sample(jax.random.PRNGKey(2))
    return (teacher.to_observed({"y": sample["y"]}),
            np.asarray(sample["x"]))


def test_entry_sweep_matches_the_jax_entry(run):
    student, states = run["entry"]
    fn, _ = graft_entry.entry(device="cpu")
    model = port_model(student)
    n_slots = ExpectationPropagation(model).n_slots
    for what, before, after in zip(("initial state", "swept state"),
                                   states, states[1:]):
        state = convert.state_from_numpy(
            *describe_state(before, n_slots), device="cpu",
            dtype=torch.float64)
        assert_states_close(fn(model, state), after, n_slots, 1e-11,
                            what=what)


def test_entry_on_the_cpu_is_the_engines_sweeps():
    fn, (student, state) = graft_entry.entry(device="cpu")
    assert student.factors[1].W.shape == (512, 1024)
    swept = fn(student, fn(student, state))
    ep = ExpectationPropagation(student).iterate(max_iter=2, tol=0,
                                                 damping=0.1)
    assert ep.n_iter == 2 and len(swept) == len(ep.state)
    for got, want in zip(swept, ep.state):
        for k, v in want.items():
            assert v.dtype == torch.float64 and v.shape in {
                (1024,), (512,), ()}, (k, v.shape)
            assert bool(torch.isfinite(got[k]).all())
            assert torch.equal(got[k], v), k


def test_entry_needs_a_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (graft_entry.entry, lambda: graft_entry.dryrun_multichip(1)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_operators_draw_apart_from_the_sample():
    """No operator's generator shares the teacher's seed: the stage seeds
    (the counterpart of ``jax.random.split``) and ``entry``'s seed 0 carry
    ``OPERATOR_STREAM``; instances get different operators and one x."""
    seeds = graft_entry._split(0, 4) + graft_entry._split(7, 2)
    assert len(set(seeds)) == 6
    assert all(s >= graft_entry.OPERATOR_STREAM for s in seeds)
    assert graft_entry.SAMPLE_SEED < graft_entry.OPERATOR_STREAM
    a, b = (graft_entry._build_glm(32, 0.5, s, device="cpu")
            for s in seeds[:2])
    assert not torch.equal(a.factors[1].W, b.factors[1].W)


def test_stage2_on_a_2x2_mesh_against_jax(run):
    ref, ref_iter = run["stage2"]
    for rank in run["worlds"][4]:
        np.testing.assert_array_equal(rank["stage2/n_iter"], ref_iter)
        for k in ("r", "v"):
            np.testing.assert_allclose(rank[f"stage2/{k}"], ref[k],
                                       rtol=1e-6, err_msg=k)


@pytest.mark.parametrize("world", [2, 4])
def test_stage4_on_the_model_axis(run, world):
    """(a) each rank holds 1/world of the operators' bytes, (b) the bytes
    the solve takes are those plus vectors (under the JAX bound of the share
    plus 32 MB), (c) the SE band, at ``STAGE4_N``."""
    for rank in run["worlds"][world]:
        r = {k.split("/")[1]: rank[k] for k in rank
             if k.startswith("stage4/")}
        assert int(r["N"]) == worker.STAGE4_N
        assert r["total_op_bytes"] == world * r["per_dev"]
        assert r["arg_bytes"] < r["total_op_bytes"] / world + 32e6
        assert r["arg_bytes"] - r["per_dev"] < 1e6
        assert abs(r["v"] - r["v_se"]) / r["v_se"] < 0.1
        assert abs(r["mse"] - r["v_se"]) / r["v_se"] < 0.25
        assert f"!= {world} processes" in str(rank["error_world"])


def test_stage4_solve_on_the_jax_instance(run):
    """Stage 4's sharded solve on (1, 2) (``_model_parallel``: checks (a)
    and (b)), on the JAX package's own stage-4 instance at ``STAGE4_N``
    (its full SVD carried over), against the JAX package's
    ``EPSolver.solve_batch`` of it: r and v at rtol 1e-6, equal n_iter.
    The finite-N band (c) is a statement about one instance: this one
    misses it (v 0.0671 against v_SE 0.0472), in both packages alike,
    where the port's instance of the same N meets it."""
    ref, ref_iter = run["stage4"]
    for rank in run["worlds"][2]:
        assert int(rank["stage4jax/n_iter"]) == ref_iter
        for k in ("r", "v"):
            np.testing.assert_allclose(rank[f"stage4jax/{k}"], ref[k],
                                       rtol=1e-6, err_msg=k)
        assert float(rank["stage4jax/ratio"]) == 2
        v_se = float(rank["stage4jax/v_se"])
        np.testing.assert_allclose(float(rank["stage4jax/v"]),
                                   ref["v"].mean(), rtol=1e-6)
        assert abs(float(rank["stage4jax/v"]) - v_se) / v_se > 0.1


@pytest.mark.parametrize("world", [2, 4])
def test_stage3_grid_and_rank0_csv(run, world):
    ranks = run["worlds"][world]
    assert [bool(r["stage3/wrote"]) for r in ranks] == [
        rank == 0 for rank in range(world)]
    for r in ranks:
        assert len(r["stage3/v"]) == 8 * world
        assert np.isfinite(r["stage3/v"]).all()
        np.testing.assert_array_equal(r["stage3/v"], ranks[0]["stage3/v"])
    assert sorted(set(ranks[0]["stage3/alpha"])) == pytest.approx(
        np.linspace(0.05, 1.0, 4 * world))


def test_dryrun_in_a_world_of_one(run):
    lines = [str(s) for s in run["worlds"][1][0]["dryrun/lines"]]
    assert [s.split(" OK:")[0] for s in lines] == [
        f"dryrun_multichip stage{k}" for k in (1, 2, 4, 3)], lines
    assert f"N={worker.STAGE4_N} model-parallel x1" in lines[2]
