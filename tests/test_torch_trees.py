"""Trees that branch, tramp_tpu_torch against tramp_tpu, float64 on the CPU.

- The shape channels (bias, sum, duplicate, concat, reshape): messages,
  log-partitions and SE updates against the JAX methods at rtol 1e-12,
  one instance and 3 lanes (each lane against the JAX call on its data).
- A duplicate channel and a sum channel in one model, sweep by sweep
  against JAX (r, v and the log evidence at rtol 1e-10).
- ``MultiLayerModel`` (tests/test_models_misc.py:152-173), ``FactorDAG``
  and ``FactorModel`` (variables inserted as the JAX package inserts them),
  and the solver route: a tree is not a chain (``chain_factors`` returns
  None), so ``dispatch_solver`` gives an ``EPSolver``.

The committees are in tests/test_torch_committee_ep.py and
tests/test_torch_committee_se.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tramp_tpu as jt
from tramp_tpu import channels as jchannels
from tramp_tpu.priors import GaussBernoulliPrior as JGaussBernoulliPrior

import tramp_tpu_torch as tt
from tramp_tpu_torch import channels, models, parallel
from tramp_tpu_torch.parallel.ml_vamp import chain_factors
from tramp_tpu_torch.priors import GaussBernoulliPrior

from torch_parity import assert_close, describe_factor, port_model

F64 = torch.float64
N = 6


def _t(x):
    return torch.as_tensor(np.asarray(x), dtype=F64)


def _port(jax_factor):
    from tramp_tpu_torch import convert
    return convert.factor_from_description(describe_factor(jax_factor),
                                           device="cpu", dtype=F64)


def _message(rng, shape, lanes=None):
    "(a, b): a precision and a mean of ``shape``, with ``lanes`` first."
    if lanes is None:
        return rng.uniform(0.5, 3.0), rng.randn(*shape)
    return (rng.uniform(0.5, 3.0, (lanes,) + (1,) * len(shape)),
            rng.randn(lanes, *shape))


def _shape_cases(rng):
    """(name, JAX factor, input shapes, output shapes): one case per shape
    channel."""
    return [
        ("bias", jchannels.BiasChannel(rng.randn(N)), [(N,)], [(N,)]),
        ("sum", jchannels.SumChannel(n_prev=3), [(N,)] * 3, [(N,)]),
        ("duplicate", jchannels.DuplicateChannel(n_next=3), [(N,)],
         [(N,)] * 3),
        ("concat", jchannels.ConcatChannel([2, 3, 1]),
         [(2,), (3,), (1,)], [(N,)]),
        ("concat_axis1", jchannels.ConcatChannel([2, 1], axis=1),
         [(3, 2), (3, 1)], [(3, 3)]),
        ("reshape", jchannels.ReshapeChannel(prev_shape=N,
                                             next_shape=(2, 3)),
         [(N,)], [(2, 3)]),
    ]


def _side(msgs, n):
    "One message, or lists, as the engines hand them to a factor."
    a = [m[0] for m in msgs]
    b = [m[1] for m in msgs]
    return (a[0], b[0]) if n == 1 else (a, b)


def _as(msgs, n, conv):
    a, b = _side(msgs, n)
    if n == 1:
        return conv(a), conv(b)
    return [conv(x) for x in a], [conv(x) for x in b]


def _flat(out):
    """A message pair or lists of them, as a flat list of (is a precision,
    array)."""
    a, b = out
    if isinstance(a, (list, tuple)):
        return [(True, x) for x in a] + [(False, x) for x in b]
    return [(True, a), (False, b)]


CASE_NAMES = [c[0] for c in _shape_cases(np.random.RandomState(0))]


@pytest.mark.parametrize("lanes", [None, 3], ids=["one", "lanes"])
@pytest.mark.parametrize("name", CASE_NAMES)
def test_shape_channel_messages(name, lanes):
    rng = np.random.RandomState(CASE_NAMES.index(name))
    _, jch, prev, nxt = next(c for c in _shape_cases(rng) if c[0] == name)
    ch = _port(jch)
    zs = [_message(rng, s, lanes) for s in prev]
    xs = [_message(rng, s, lanes) for s in nxt]
    args = _as(zs, len(prev), _t) + _as(xs, len(nxt), _t)
    for method in ("compute_forward_message", "compute_backward_message",
                   "compute_log_partition"):
        got = getattr(ch, method)(*args)
        for i in range(lanes or 1):
            def lane(x, precision=False, i=i):
                "Lane i of a port array; a precision's one value, 0-d."
                x = np.asarray(x)
                if not lanes:
                    return x
                return x[i].reshape(()) if precision else x[i]
            jzs = [(lane(a, True), jnp.asarray(lane(b))) for a, b in zs]
            jxs = [(lane(a, True), jnp.asarray(lane(b))) for a, b in xs]
            want = getattr(jch, method)(*(_side(jzs, len(prev))
                                          + _side(jxs, len(nxt))))
            if method == "compute_log_partition":
                assert_close(lane(got.numpy(), True), want, 1e-12,
                             what=f"{name} {method}")
                continue
            for (precision, g), (_, w) in zip(_flat(got), _flat(want)):
                assert_close(lane(g.numpy(), precision), w, 1e-12,
                             what=f"{name} {method} lane {i}")


def test_shape_channel_lanes_keep_the_lane_axis_first():
    "A lane's precision and message keep the lane axis and their shapes."
    ch = channels.ReshapeChannel(prev_shape=N, next_shape=(2, 3))
    a, b = ch.compute_forward_message(torch.ones(4, 1), torch.ones(4, N),
                                      None, None)
    assert a.shape == (4, 1, 1) and b.shape == (4, 2, 3)
    a, b = ch.compute_backward_message(None, None, torch.ones(4, 1, 1),
                                       torch.ones(4, 2, 3))
    assert a.shape == (4, 1) and b.shape == (4, N)
    cat = channels.ConcatChannel([2, 1], axis=0)
    rx, vx = cat.compute_forward_posterior(
        [torch.ones(4, 1), torch.ones(4, 1)],
        [torch.ones(4, 2), torch.ones(4, 1)], torch.ones(4, 1),
        torch.ones(4, 3))
    assert rx.shape == (4, 3) and vx.shape == (4, 1)


@pytest.mark.parametrize("name", CASE_NAMES)
def test_shape_channel_state_evolution(name):
    rng = np.random.RandomState(50 + CASE_NAMES.index(name))
    _, jch, prev, nxt = next(c for c in _shape_cases(rng) if c[0] == name)
    ch = _port(jch)
    az = [rng.uniform(0.5, 3.0) for _ in prev]
    ax = [rng.uniform(0.5, 3.0) for _ in nxt]
    taus = [rng.uniform(0.5, 2.0) for _ in prev]

    def one(x):
        return x[0] if len(x) == 1 else x

    def t(x, lanes=False):
        if isinstance(x, list):
            return [t(v, lanes) for v in x]
        return _t([[x]] * 3) if lanes else _t(x)

    for lanes in (False, True):
        jargs = (one(az), one(ax), one(taus))
        args = (one(t(az, lanes)), one(t(ax, lanes)), one(t(taus, lanes)))
        for method in ("compute_forward_state_evolution",
                       "compute_backward_state_evolution"):
            got, want = (getattr(ch, method)(*args),
                         getattr(jch, method)(*jargs))
            got = got if isinstance(got, list) else [got]
            want = want if isinstance(want, list) else [want]
            for g, w in zip(got, want):
                g = g.numpy()
                assert g.shape == ((3, 1) if lanes else ())
                assert_close(g.reshape(-1)[0], w, 1e-12, what=method)
        tau_prev = args[2]
        if not isinstance(tau_prev, list):
            tau_prev = [tau_prev]
        second = ch.second_moment(*tau_prev)
        j_second = jch.second_moment(*(taus if len(taus) > 1 else taus))
        for g, w in zip(second if isinstance(second, tuple) else [second],
                        j_second if isinstance(j_second, tuple)
                        else [j_second]):
            assert_close(torch.as_tensor(g).reshape(-1)[0], w, 1e-12)


def test_tree_goes_to_ep_solver():
    """chain_factors returns None for a model with a SIMO or MISO variable,
    and dispatch_solver gives such a tree to EPSolver: a route through
    MLVAMPSolver would solve another model without raising."""
    committee = models.soft_committee(
        K=2, N=N, alpha=1.5, ensemble_type="gaussian",
        prior_mean=[0.1, -0.2], prior_var=[1.0, 1.0], noise_var=1e-2,
        generator=torch.Generator().manual_seed(0), device="cpu", dtype=F64)
    assert chain_factors(committee) is None
    assert type(parallel.dispatch_solver(committee)) is parallel.EPSolver
    # a SIMO variable: x feeds two observations of itself
    prior = GaussBernoulliPrior(size=N, device="cpu", dtype=F64)
    dag = (prior @ tt.SIMOVariable(id="x", n_next=2)
           @ (channels.GaussianChannel(var=0.1) + channels.GaussianChannel(
               var=0.2))
           @ (tt.O(id="y_0") + tt.O(id="y_1")))
    simo = dag.to_model()
    assert chain_factors(simo) is None
    student = simo.to_observed({"y_0": torch.ones(N, dtype=F64),
                                "y_1": torch.ones(N, dtype=F64)})
    assert chain_factors(student) is None
    assert type(parallel.dispatch_solver(student)) is parallel.EPSolver
    # a MISO variable feeding a chain is still no chain
    miso = (GaussBernoulliPrior(size=N, device="cpu", dtype=F64)
            @ tt.V(id="x") @ channels.DuplicateChannel(n_next=2)
            @ (tt.V(id="x_0") + tt.V(id="x_1"))
            @ channels.SumChannel(n_prev=2) @ tt.V(id="s")
            @ channels.GaussianChannel(var=0.1) @ tt.O(id="y")).to_model()
    student = miso.to_observed({"y": torch.ones(N, dtype=F64)})
    assert chain_factors(student) is None
    assert type(parallel.dispatch_solver(student)) is parallel.EPSolver
    # the plain chain still goes to the chain solver
    chain = (GaussBernoulliPrior(size=N, device="cpu", dtype=F64)
             @ tt.V(id="x") @ channels.AbsChannel() @ tt.V(id="z")
             @ channels.GaussianChannel(var=0.1) @ tt.O(id="y")).to_model()
    student = chain.to_observed({"y": torch.ones(N, dtype=F64)})
    assert chain_factors(student) is not None
    assert type(parallel.dispatch_solver(student)) is parallel.MLVAMPSolver


def test_duplicate_and_sum_ep_matches_jax():
    """x -> duplicate -> two noisy copies summed back: a SIMO factor and a
    MISO factor in one model, against JAX sweep by sweep."""
    rng = np.random.RandomState(3)
    y = rng.randn(20)
    j_model = (JGaussBernoulliPrior(size=20, rho=0.4) @ jt.V(id="x")
               @ jchannels.DuplicateChannel(n_next=2)
               @ (jt.V(id="x_0") + jt.V(id="x_1"))
               @ (jchannels.GaussianChannel(var=0.3)
                  + jchannels.GaussianChannel(var=0.5))
               @ (jt.V(id="u_0") + jt.V(id="u_1"))
               @ jchannels.SumChannel(n_prev=2) @ jt.V(id="s")
               @ jchannels.GaussianChannel(var=0.1) @ jt.O(id="y")
               ).to_model()
    j_student = j_model.to_observed({"y": jnp.asarray(y)})
    student = port_model(j_student)
    ep = tt.ExpectationPropagation(student).iterate(max_iter=30, damping=0.2)
    j_ep = jt.ExpectationPropagation(j_student)
    j_ep.iterate(max_iter=30, damping=0.2)
    assert ep.n_iter == j_ep.n_iter
    for id in ("x", "x_0", "u_1", "s"):
        d, j_d = ep.get_variable_data(id), j_ep.get_variable_data(id)
        assert_close(d["r"], j_d["r"], 1e-10, what=id)
        assert_close(d["v"], j_d["v"], 1e-10, what=id)
    assert_close(ep.log_evidence(), j_ep.log_evidence(), 1e-10)


def test_multi_layer_model():
    """MultiLayerModel with default ids x, t_1, y (reference
    multi_layer_model.py:21-49); the magnitude t_1 = |x| is recovered to
    the noise floor, and the sweeps match JAX's."""
    from tramp_tpu.models import MultiLayerModel as JMultiLayerModel
    from tramp_tpu.priors import GaussBernoulliPrior as JGB
    from tramp_tpu_torch.models import MultiLayerModel

    g = torch.Generator().manual_seed(0)
    model = MultiLayerModel(
        [GaussBernoulliPrior(size=50, rho=0.5, device="cpu", dtype=F64),
         channels.AbsChannel(), channels.GaussianChannel(var=1e-2)])
    assert model.ids == ["x", "t_1", "y"]
    sample = model.sample(g)
    assert set(sample) == {"x", "t_1", "y"}
    student = model.to_observed({"y": sample["y"]})
    ep = tt.ExpectationPropagation(student).iterate(max_iter=100, damping=0.3)
    r_t = ep.get_variable_data("t_1")["r"]
    assert float(((r_t - sample["t_1"]) ** 2).mean()) < 5e-2

    j_model = JMultiLayerModel([JGB(size=50, rho=0.5),
                                jchannels.AbsChannel(),
                                jchannels.GaussianChannel(var=1e-2)])
    j_student = j_model.to_observed({"y": jnp.asarray(sample["y"].numpy())})
    mine = port_model(j_student)
    ep = tt.ExpectationPropagation(mine).iterate(max_iter=100, damping=0.3)
    j_ep = jt.ExpectationPropagation(j_student)
    j_ep.iterate(max_iter=100, damping=0.3)
    assert ep.n_iter == j_ep.n_iter
    for id in ("x", "t_1"):
        assert_close(ep.get_variable_data(id)["r"],
                     j_ep.get_variable_data(id)["r"], 1e-8, what=id)


def test_factor_dag_inserts_variables_as_jax_does():
    """A DAG of factors alone: FactorDAG and FactorModel insert x_i on
    factor->factor edges and y_j on the leaf edges, in the JAX package's
    order; the result samples and solves like the named model."""
    from tramp_tpu_torch.models import FactorDAG, FactorModel
    from tramp_tpu.models import FactorModel as JFactorModel

    W = np.random.RandomState(1).randn(8, N) / np.sqrt(N)
    prior = GaussBernoulliPrior(size=N, rho=0.5, device="cpu", dtype=F64)
    dag = (prior @ channels.LinearChannel(W, device="cpu", dtype=F64)
           @ channels.GaussianChannel(var=0.1))
    assert not isinstance(dag, FactorDAG)
    factor_dag = dag.to_factor_dag()
    assert isinstance(factor_dag, FactorDAG)
    model = FactorModel(factor_dag)
    j_model = JFactorModel(
        (JGaussBernoulliPrior(size=N, rho=0.5) @ jchannels.LinearChannel(
            jnp.asarray(W)) @ jchannels.GaussianChannel(var=0.1)
         ).to_factor_dag())
    assert model.variable_ids == j_model.variable_ids == ["x_0", "x_1",
                                                          "y_0"]
    assert dag.to_model().variable_ids == model.variable_ids
    sample = model.sample(torch.Generator().manual_seed(0))
    assert sample["y_0"].shape == (8,)
    with pytest.raises(ValueError, match="Factor or PlaceHolder"):
        FactorDAG((prior @ tt.V(id="x")).dag)
    with pytest.raises(ValueError, match="missing priors"):
        FactorModel(FactorDAG(channels.GaussianChannel(var=0.1)))
    with pytest.raises(ValueError, match="RootPlaceHolders"):
        FactorDAG(channels.GaussianChannel(var=0.1)).to_model_dag()


@pytest.mark.parametrize("engine", ["EP", "SE"])
def test_one_sweep_of_a_tree_from_a_jax_state(engine):
    """The JAX engine's state of the soft committee after 3 sweeps (several
    edges per variable, list messages at the sum channel), exported and
    converted (torch_parity.describe_state, convert.state_from_numpy): one
    more sweep of each engine from it agrees slot by slot, at rtol 1e-10."""
    from tramp_tpu_torch import convert
    from torch_parity import assert_states_close, committee_case, \
        describe_state
    j_student, student, _ = committee_case("soft", seed=2)
    if engine == "EP":
        j_eng, eng = jt.ExpectationPropagation(j_student), \
            tt.ExpectationPropagation(student)
    else:
        j_eng, eng = jt.StateEvolution(j_student), \
            tt.StateEvolution(student, device="cpu")
    damp = j_eng._damping_per_slot(0.3)
    state = j_eng.init_state()
    for _ in range(3):
        state = j_eng._sweep(j_eng.model, state, damp)
    p_state = convert.state_from_numpy(
        *describe_state(state, j_eng.n_slots), device="cpu", dtype=F64)
    j_next = j_eng._sweep(j_eng.model, state, damp)
    p_next = eng._sweep(eng.model, p_state, eng._damping_per_slot(0.3),
                        eng._prepare(eng.model))
    if engine == "EP":
        assert_states_close(p_next, j_next, j_eng.n_slots, 1e-10,
                            what="EP sweep")
        return
    for s in range(j_eng.n_slots):
        assert_close(p_next[s]["a"], j_next[s]["a"], 1e-10,
                     what=f"SE slot {s}")
