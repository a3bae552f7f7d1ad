"""Batched EP and SE solvers: many problem instances in one loop of the
generic engine. Counterpart of tramp_tpu/parallel/solver.py (``EPSolver``,
``SESolver``).

The JAX package stacks the instances into one pytree and ``vmap``s a
compiled ``while_loop``. Here the instances are a lane axis written out
(tramp_tpu_torch/lanes.py): the engine's ``_sweep`` runs once per iteration
on a state whose messages are ``(B, n)`` with precisions ``(B, 1)``, against
a model whose buffers carry the lanes. The loop, its flags and frozen lanes,
and its replay as a CUDA graph on the card are ``parallel/loop.py``'s
(``SolverLoop``, ``Plan``). Its iteration here (``_Solver._iterate``): a
sweep that is not finite is dropped and ends its lane, and a lane whose
metric grows past the rollback bound goes back to its previous state and
ends. A plan copies in every buffer and per-lane hyperparameter of the
model, so a grid whose every point changes the prior and the channel
(``parallel.build_se_grid``) replays one capture.

On a model sharded over a device mesh (``parallel.mesh``) each rank runs the
loop on its own lanes; the stop flag is reduced over the mesh
(``all_reduce(MIN)``, still one host read per iteration), and the results
are gathered, so every rank returns the whole batch. Split over the data
axis alone, each lane has the bits of the unsharded solve (ranks whose
products sum in the same order; done lanes are frozen); the model axis
changes the order of summation of each product. ``solve_batch_shard_map``
lets each rank stop when its own lanes are done.

The convergence-gated throughput mode (``solve_gated_bf16``,
``solve_batch_gated_bf16``) runs the loop twice: with the message state
stored in bfloat16 (``config.STATE_BF16``) to a coarse tol, then from that
state, upcast, in float32 to the solver's own tol.
"""
import torch

from .. import config
from ..algos import ExpectationPropagation, StateEvolution
from ..lanes import (
    advance, lane_precision, lane_values, model_lanes, select, select_,
    stack_models, to_lanes,
)
from .loop import SolverLoop, start_flags, tensor_fields
from .mesh import map_tree, shard_batched_model, whole_batch

def stack_pytrees(trees, device=None, dtype=None):
    """The JAX package's name for ``lanes.stack_models``, with its parameter
    name: ``trees`` are same-structure models."""
    return stack_models(trees, device=device, dtype=dtype)


class _Solver(SolverLoop):
    """A generic engine behind the solvers' call surface:
    ``solve(model) -> ({id: posterior data}, n_iter)`` and ``solve_batch``.

    ``model`` provides the static structure (one representative instance).
    Solve calls accept any model of that structure; ``solve_batch`` takes
    one whose buffers carry lanes. A buffer has lanes when it has one axis
    more than the same buffer of ``model`` (``lanes.model_lanes``), so both
    layouts work: whole models stacked (``lanes.stack_models``: an operator,
    its SVD factors and an observation per lane) and one model with only
    some buffers stacked (``lanes.with_buffers``: one shared operator, an
    observation per lane); numeric hyperparameters that differ between the
    stacked models are one value per lane too.

    ``wait_increase`` / ``rollback_increase`` tune the divergence rollback
    (reference EarlyStopping(wait_increase, max_increase) semantics) and
    default to the engine's values; ``rollback_increase=float("inf")``
    disables it. ``stop_kind`` overrides the engine's stopping metric: "r"
    (max relative posterior-mean change, the EP default) or "v" (|delta| of
    the per-variable mean posterior variance)."""

    engine_cls = None

    def __init__(self, model, damping=None, tol=1e-6, max_iter=200,
                 wait_increase=None, rollback_increase=None, stop_kind=None,
                 **engine_kwargs):
        self.engine = eng = self.engine_cls(model, **engine_kwargs)
        self.damp = eng._damping_per_slot(float(damping) if damping else None)
        self.tol = tol
        self.max_iter = max_iter
        self.wait_increase = (eng.wait_increase if wait_increase is None
                              else wait_increase)
        self.rollback_increase = (
            eng.rollback_increase if rollback_increase is None
            else rollback_increase)
        self.stop_kind = stop_kind or eng.default_stop_kind

    def init_state(self, initializer=None):
        "The engine's initial state of one instance (no lanes)."
        return self.engine.init_state(initializer)

    def _with_lanes(self, state, B):
        """An initial state without lanes, repeated for B lanes: messages
        ``(B, n)``, one-element precisions ``(B, 1)``."""
        eng = self.engine
        slots = tuple(
            {"a": (lane_precision(m["a"], B, m["b"].ndim)
                   if m["a"].numel() == 1 else to_lanes(m["a"], B)),
             "b": to_lanes(m["b"], B)}
            for m in state[:eng.n_slots])
        if eng.spectral_factors:
            slots += ({k: to_lanes(v, B)
                       for k, v in state[eng.n_slots].items()},)
        return slots

    def _prepare(self, model, state):
        """The run's lane count, device, ``aux`` (the run's second moments
        or pinned messages) and state, whose carried spectral images are
        derived from this model's operators, lane by lane (the same matvec
        the first uncached forward pass does)."""
        eng = self.engine
        aux = eng._prepare(model)
        if eng.spectral_factors:
            state = eng._refresh_spectral_cache(state, model)
        aux = eng._fill_aux(model, state, aux)
        return eng._lanes(state), state[0]["a"].device, aux, state

    def _start(self, model, aux, B, state):
        """The loop's state before its first iteration, which ``_iterate``
        updates in place: a copy of ``state`` (the messages, which the loop
        writes), the stop metric and the flags."""
        return {"carry": map_tree(torch.clone, state),
                "metric": self._metric(state, aux),
                "flags": start_flags(B, state[0]["a"].device)}

    def _metric(self, state, aux):
        return self.engine._metric(state, self.stop_kind)

    def _iterate(self, model, aux, B, loop, tol):
        """One iteration of the loop, in place on ``loop`` (``_start``):
        the sweep, the finite test, the stop metric, the rollback, the
        frozen lanes and the flags, all on the device, with no host read."""
        eng, kind = self.engine, self.stop_kind
        state, old_m, flags = loop["carry"], loop["metric"], loop["flags"]
        swept = eng._sweep(model, state, self.damp, aux)
        ok = eng._all_finite(swept)
        swept = tuple({k: select(ok, a[k], b[k]) for k in a}
                      for a, b in zip(swept, state))
        new_m = eng._metric(swept, kind)
        delta, inc = eng._delta_increase(kind, new_m, old_m, lanes=B)
        count = flags["count"]
        converged = (delta < tol) & (count > 0)
        # divergence rollback (reference EarlyStopping semantics)
        rb = (inc > self.rollback_increase) & (count > self.wait_increase)
        # a lane that is done is frozen: its fixed point and its n_iter
        # stay while the slower lanes go on (its metric is read by nothing
        # once it is done). Without lanes the loop ends with it.
        active = ~flags["done"]
        keep = ~rb if B is None else active & ~rb
        for new, old in zip(swept, state):
            for k in old:
                select_(keep, new[k], old[k])
        for n, o in zip(new_m, old_m):
            o.copy_(n)
        advance(flags, active, converged, rb | ~ok)

    def _readout(self, model, state, aux, B):
        eng = self.engine
        return {eng.nodes[vi].id: self._post(vi, state, B)
                for vi in eng.variable_indices}

    def _copied(self, model):
        "What a plan copies in: every buffer and per-lane hyperparameter."
        return tensor_fields(model, range(len(model.factors)))

    def _numbers(self):
        "What the iteration reads of the solver and its engine."
        eng = self.engine
        return (type(eng), self.damp, self.stop_kind, self.wait_increase,
                self.rollback_increase, eng.pinned, eng.spectral_factors,
                config.state_bf16())

    def solve(self, model, initializer=None):
        "Solve one instance; returns dict id -> posterior data, and n_iter."
        post, n_iter, _ = self.solve_info(model, initializer)
        return post, n_iter

    def solve_info(self, model, initializer=None):
        """Like solve but also returns the converged flag (True iff the
        delta < tol criterion fired; False for divergence-rollback,
        non-finite and max_iter stops)."""
        post, _, n_iter, conv = self._run(model, self.init_state(initializer))
        return post, n_iter, conv

    def solve_batch(self, stacked_model, initializer=None, state=None):
        """Solve a batch of instances (a model whose buffers carry lanes).
        ``initializer`` gives the initial state of every lane, or is a list
        of initializers, one per lane (an informed ``CustomInit`` each); the
        loop runs until every lane is done. Passing ``state`` (a state with
        lanes, as ``solve_batch_with_state`` returns it) resumes from it.
        On a sharded model (``shard_batched_model``) every rank returns the
        whole batch; ``state`` may hold the whole batch or this rank's
        lanes (``shard_batched_state``)."""
        post, _, n_iter, _ = self._solve_batch(stacked_model, initializer,
                                               state)
        return whole_batch((post, n_iter), stacked_model)

    def solve_batch_with_state(self, stacked_model, initializer=None,
                               state=None):
        """Like solve_batch but also returns the final message state with
        its lanes, for warm restarts."""
        post, state, n_iter, _ = self._solve_batch(
            stacked_model, initializer, state, own_state=True)
        return whole_batch((post, state, n_iter), stacked_model)

    def _solve_batch(self, stacked_model, initializer=None, state=None,
                     stop=None, tol=None, own_state=False):
        """The batched loop on this rank's lanes: (post, state, n_iter,
        conv), not gathered; ``stop`` and ``tol`` as in ``_run``,
        ``own_state`` its ``own``."""
        B = model_lanes(stacked_model, self.engine.model)
        if B is None:
            raise ValueError("solve_batch: no buffer of the model has lanes")
        where = getattr(stacked_model, "mesh_lanes", None)
        if state is None and isinstance(initializer, (list, tuple)):
            total = B if where is None else where.lanes
            if len(initializer) != total:
                raise ValueError(f"solve_batch: {len(initializer)} "
                                 f"initializers for {total} lanes")
            states = [self._with_lanes(self.init_state(iz), 1)
                      for iz in initializer]
            state = tuple({k: torch.cat([st[s][k] for st in states])
                           for k in states[0][s]}
                          for s in range(len(states[0])))
        elif state is None:
            state = self._with_lanes(self.init_state(initializer), B)
        if where is not None:
            state = where.local(state)
        return self._run(stacked_model, state, stop, tol, own_state)

    # -- convergence-gated throughput mode (bf16 state, then float32) -------
    # (tramp_tpu/parallel/solver.py:183-318). bfloat16 storage floors the
    # relative-r stop metric at bfloat16's resolution, so a tight tol never
    # fires on the bf16 trajectory: phase 1 stops at a coarse tol above that
    # floor, phase 2 upcasts the state once and polishes to ``self.tol``.
    #: phase 1's tol for stop kind "r" (the JAX package's value)
    BF16_COARSE_TOL = 5e-3
    #: phase 1's tol for stop kind "v", whose mean over a variable cancels
    #: much of the elementwise rounding (the JAX package's value)
    BF16_COARSE_TOL_V = 1e-5

    def _coarse_default(self):
        return (self.BF16_COARSE_TOL_V if self.stop_kind == "v"
                else self.BF16_COARSE_TOL)

    @staticmethod
    def _upcast_state(state):
        "``state`` with every bfloat16 array made float32."
        return map_tree(
            lambda x: x.float() if x.dtype == torch.bfloat16 else x, state)

    @staticmethod
    def _stored_as(bf16, run):
        """``run()`` with ``config.STATE_BF16`` set to ``bf16``, and set back
        after, whatever the caller had: the engine reads it at every store."""
        prev = config.STATE_BF16
        config.STATE_BF16 = bf16
        try:
            return run()
        finally:
            config.STATE_BF16 = prev

    # Phase 1's state may be the buffers of its plan; phase 2 copies it into
    # its own plan's buffers (``loop.Plan.load``) before it writes any, so
    # the state needs no copy of its own.
    def solve_gated_bf16(self, model, initializer=None, coarse_tol=None):
        """One instance in two phases: sweeps with the state stored in
        bfloat16 until the stop metric falls below ``coarse_tol`` (None:
        ``BF16_COARSE_TOL``, or ``BF16_COARSE_TOL_V`` for stop kind "v"),
        then float32 sweeps from that state, upcast, to ``self.tol``; the
        second phase stores float32 also where ``config.STATE_BF16`` is on.
        Returns (post, n_iter_total, conv, {"n_iter_bf16", "n_iter_f32",
        "coarse_fired"}); ``conv`` is the second phase's."""
        coarse = self._coarse_default() if coarse_tol is None else coarse_tol
        _, state1, n1, conv1 = self._stored_as(True, lambda: self._run(
            model, self.init_state(initializer), tol=coarse))
        post, _, n2, conv2 = self._stored_as(False, lambda: self._run(
            model, self._upcast_state(state1)))
        return (post, int(n1) + int(n2), conv2,
                dict(n_iter_bf16=int(n1), n_iter_f32=int(n2),
                     coarse_fired=bool(conv1)))

    def solve_batch_gated_bf16(self, stacked_model, initializer=None,
                               coarse_tol=None):
        """``solve_gated_bf16`` for a batch (a model whose buffers carry
        lanes, as ``solve_batch`` takes it; sharded too, and then every rank
        returns the whole batch). Returns (post, n_iter_total, conv), per
        lane; ``conv`` is the float32 phase's."""
        coarse = self._coarse_default() if coarse_tol is None else coarse_tol
        _, state1, n1, _ = self._stored_as(True, lambda: self._solve_batch(
            stacked_model, initializer, tol=coarse))
        post, _, n2, conv = self._stored_as(False, lambda: self._solve_batch(
            stacked_model, state=self._upcast_state(state1)))
        return whole_batch((post, n1 + n2, conv), stacked_model)


def solve_batch_shard_map(solver, stacked_model, mesh, data_axis="data",
                          initializer=None):
    """A batched solve whose ranks stop on their own: the lanes are split
    over the mesh's ``data_axis`` and each rank runs the loop on its lanes
    until they are done, with no collective over the data axis inside the
    loop (the counterpart of the JAX package's ``jax.shard_map`` path;
    ``solve_batch`` on a sharded model runs one loop to the slowest lane).
    The only communication over the data axis comes at the end: an
    ``all_gather`` of the posteriors and iteration counts and an
    ``all_reduce(SUM)`` of the converged count. Where the mesh also splits
    the operators over a model axis, the ranks of that axis share lanes and
    reduce their stop flag among themselves.

    ``solver`` is an ``EPSolver``, ``SESolver``, ``SpectralVAMPSolver`` or
    ``MLVAMPSolver``; ``stacked_model`` a model whose buffers carry lanes
    (``lanes.stack_models``, ``with_buffers``), or one already sharded on
    ``mesh``. Each lane has the bits of ``solve_batch`` (done lanes are
    frozen either way), and a repeated call gives the same bits. Returns
    ``(post, n_iter, n_converged)``, the same on every rank;
    ``n_converged`` counts the lanes whose stop criterion was met (delta <
    tol), not those ended by a rollback or a sweep that was not finite.

    ``initializer`` must be one initializer for every lane: per-lane lists
    are only taken by ``solve_batch``."""
    if isinstance(initializer, (list, tuple)):
        raise ValueError(
            "solve_batch_shard_map broadcasts one initial state across the "
            "batch; per-instance initializer lists are only supported by "
            "solve_batch")
    where = getattr(stacked_model, "mesh_lanes", None)
    if where is None:
        stacked_model = shard_batched_model(stacked_model, mesh, data_axis)
        where = stacked_model.mesh_lanes
    elif where.mesh is not mesh or where.data_axis != data_axis:
        raise ValueError("solve_batch_shard_map: the model is sharded on "
                         "another mesh or data axis")
    post, _, n_iter, conv = solver._solve_batch(
        stacked_model, initializer, None, stop=where.stop_groups(False))
    post, n_iter = where.gather((post, n_iter))
    return post, n_iter, where.count(conv)


class EPSolver(_Solver):
    "``_Solver`` on ``ExpectationPropagation``: posterior data ``{r, v}``."
    engine_cls = ExpectationPropagation

    def _post(self, vi, state, B):
        p = self.engine._posterior(vi, state)
        return dict(r=p["b"] / p["a"], v=lane_values(1.0 / p["a"], B))


class SESolver(_Solver):
    """``_Solver`` on ``StateEvolution``: posterior data ``{v}``, 0-d for
    one instance and ``(B,)`` for a batch. ``device`` and ``dtype`` go to
    the engine (the first card and float64 unless given); the per-lane
    hyperparameters of a stacked model must lie on that device
    (``stack_models(models, device=...)``)."""
    engine_cls = StateEvolution

    def _with_lanes(self, state, B):
        return tuple({"a": lane_precision(m["a"], B, 1)} for m in state)

    def _post(self, vi, state, B):
        p = self.engine._posterior(vi, state)
        return dict(v=lane_values(1.0 / p["a"], B))
