"""Batched EP and SE solvers: many problem instances in one loop of the
generic engine. Counterpart of tramp_tpu/parallel/solver.py (``EPSolver``,
``SESolver``).

The JAX package stacks the instances into one pytree and ``vmap``s a
compiled ``while_loop``. Here the instances are a lane axis written out
(tramp_tpu_torch/lanes.py): the engine's ``_sweep`` runs once per iteration
on a state whose messages are ``(B, n)`` with precisions ``(B, 1)``, against
a model whose buffers carry the lanes, and the stop flags are one per lane,
read by the host once per iteration (``done.all()``). The loop keeps the
``while_loop``'s semantics lane by lane: a sweep that is not finite is
dropped and ends its lane, a lane whose metric grows past the rollback
bound goes back to its previous state and ends, and a lane that is done is
frozen (its state and its ``n_iter`` stay) while the slower lanes go on, so
a lane of a batched solve follows the single solve on that lane's data. An
iteration (``_Solver._iterate``) updates the loop's state in place on the
device, with no host read.

On the card, off a mesh, the iteration is captured as one CUDA graph
(``_Plan``), and each iteration replays it: one launch where the eager
iteration makes hundreds (about 300 for an SE phase grid, whose loop is
otherwise bound by the host's launches). Each solve copies its model's
tensors, the run's ``aux`` and its initial state into the plan's buffers,
and a replay runs the eager iteration's kernels, so the answers are the
same bits. The plans live on the solver's class, one per lane count,
replaced when what the graph reads beyond those copies differs (the
structure, the numbers, tol, the switches: ``_signature``): a front door
that makes a new solver for every call (``parallel.build_se_grid``) still
captures once. A model on the CPU or on a mesh, and a sweep that reads the
device from the host (whose capture raises), run the same iteration
eagerly.

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
import numpy as np
import torch

from .. import config, trace
from ..algos import ExpectationPropagation, StateEvolution
from ..lanes import (
    hyperparameters, lane_precision, lane_values, model_lanes, select,
    stack_models, to_lanes, with_buffers,
)
from . import graphs
from .mesh import (
    all_done, map_tree, shard_batched_model, stop_groups, whole_batch,
)

def stack_pytrees(trees, device=None, dtype=None):
    """The JAX package's name for ``lanes.stack_models``, with its parameter
    name: ``trees`` are same-structure models."""
    return stack_models(trees, device=device, dtype=dtype)


class _Solver:
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

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        #: the loop's buffers and captured iteration (``_Plan``) by lane
        #: count, shared by the solvers of this class
        cls._plans = {}

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

    def _start(self, state, B):
        """The loop's state before its first iteration, which ``_iterate``
        updates in place: ``state`` (a copy of the messages, which the loop
        writes), the stop metric and the flags ``n_iter``, ``conv`` and
        ``done``, one per lane, and ``count``, the iterations run, on the
        device."""
        msgs = [{k: v.clone() for k, v in m.items()} for m in state]
        device = state[0]["a"].device
        flags = () if B is None else (B,)
        return {"state": msgs,
                "metric": self.engine._metric(state, self.stop_kind),
                "flags": {
                    "n_iter": torch.zeros(flags, dtype=torch.int64,
                                          device=device),
                    "conv": torch.zeros(flags, dtype=torch.bool,
                                        device=device),
                    "done": torch.zeros(flags, dtype=torch.bool,
                                        device=device),
                    "count": torch.zeros((), dtype=torch.int64,
                                         device=device)}}

    def _iterate(self, model, aux, B, loop, tol):
        """One iteration of the loop, in place on ``loop`` (``_start``):
        the sweep, the finite test, the stop metric, the rollback, the
        frozen lanes and the flags, all on the device, with no host read.
        The eager loop runs it, and the graph of ``_Plan`` is a capture of
        it."""
        eng, kind = self.engine, self.stop_kind
        state, old_m, flags = loop["state"], loop["metric"], loop["flags"]
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
                _write(old[k], new[k], keep)
        for n, o in zip(new_m, old_m):
            o.copy_(n)
        torch.where(active, count + 1, flags["n_iter"], out=flags["n_iter"])
        # conv records actual convergence (delta < tol), distinct from
        # done, which also latches on rollback and non-finite sweeps
        flags["conv"] |= active & converged
        flags["done"] |= converged | rb | ~ok
        count += 1

    def _why_eager(self, model, state, groups):
        """Why a solve of ``model`` from ``state`` runs its loop eagerly,
        or None where it can replay a captured graph (``_Plan``): on a mesh
        (``shard_batched_model``) the stop flag is reduced over ranks, and
        off the card there is no graph."""
        if groups or getattr(model, "mesh_lanes", None) is not None:
            return "the model is on a mesh"
        if state[0]["a"].device.type != "cuda":
            return "the state is not on a CUDA device"
        return None

    def _signature(self, model, aux, state, B, tol):
        """What a captured graph reads beyond what ``_Plan.load`` copies
        in: the structure, every factor's fields (a tensor by its layout,
        since it is copied in, and anything else by its value), a tensor
        the factor holds beside its fields by its storage, the layouts of
        ``aux`` and of the state, the loop's numbers and the switches the
        sweep reads."""
        eng = self.engine
        out = [type(self), type(eng), B, tol, self.damp, self.stop_kind,
               self.wait_increase, self.rollback_increase, eng.pinned,
               eng.spectral_factors, config.state_bf16(),
               config.matvec_bf16(), config.VMIN, config.AMIN, config.AMAX,
               torch.backends.cuda.matmul.allow_tf32,
               [type(n) for n in model.nodes], model.edges]
        for f in model.factors:
            copied = _copied(f)
            out.append(type(f))
            for name in type(f)._data_fields + type(f)._meta_fields:
                out.append((name, _value(getattr(f, name, None),
                                         name in copied)))
            out += [(name, _value(v, False)) for name, v in vars(f).items()
                    if isinstance(v, torch.Tensor) and name not in copied]
        out += [_layout(v) for v in graphs.leaves((aux, state))]
        return out

    def _plan(self, model, aux, state, B, tol):
        """The ``_Plan`` of ``B`` lanes, kept on the solver's class (so
        that a new solver of a structure already captured replays its
        graph): made at the first solve that can replay one, and again
        where the signature differs; None where the capture of this
        signature has raised (the loop then runs eagerly)."""
        signature = self._signature(model, aux, state, B, tol)
        plans = type(self)._plans
        plan = plans.get(B)
        if plan is None or plan.signature != signature:
            # the old plan's buffers and graph go before the new ones
            plans.pop(B, None)
            del plan
            plan = plans[B] = _Plan(self, model, aux, state, B, tol,
                                    signature)
        return None if plan.failed else plan

    def _run(self, model, state, stop=None, tol=None, own_state=False):
        """The loop from ``state``; ``stop``: the process groups its stop
        flag is reduced over (None: those of the model's mesh, if any);
        ``tol``: None for the solver's own. Returns (post, state, n_iter,
        conv); the state is the plan's own on the graph path (the next
        solve of as many lanes overwrites it) unless ``own_state``."""
        with trace.span("solve"):
            eng = self.engine
            tol = self.tol if tol is None else tol
            groups = stop_groups(model) if stop is None else stop
            B = eng._lanes(state)
            aux = eng._prepare(model)
            if eng.spectral_factors:
                # the carried spectral images are derived from this
                # model's operators, lane by lane (the same matvec the
                # first uncached forward pass does)
                state = eng._refresh_spectral_cache(state, model)
            aux = eng._fill_aux(model, state, aux)
            plan = (None if self._why_eager(model, state, groups)
                    else self._plan(model, aux, state, B, tol))
            if plan is None:
                loop = self._start(state, B)

                def iterate():
                    self._iterate(model, aux, B, loop, tol)
            else:
                loop = plan.load(self, model, aux, state)

                def iterate():
                    plan.step(self)
            for _ in range(self.max_iter):
                with trace.span("sweep"):
                    iterate()
                # the one host read of the iteration
                if all_done(loop["flags"]["done"], groups):
                    break
            state, flags = tuple(loop["state"]), loop["flags"]
            with trace.span("readout"):
                post = {eng.nodes[vi].id: self._post(vi, state, B)
                        for vi in eng.variable_indices}
            n_iter, conv = flags["n_iter"], flags["conv"]
            if plan is not None:
                if plan.failed:
                    # later solves of this signature run eagerly
                    plan.release()
                n_iter, conv = n_iter.clone(), conv.clone()
                if own_state:
                    state = map_tree(torch.clone, state)
            return post, state, n_iter, conv

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
        conv), not gathered; ``stop``, ``tol`` and ``own_state`` as in
        ``_run``."""
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
    # its own plan's buffers (``_Plan.load``) before it writes any, so the
    # state needs no copy of its own.
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


class _Plan:
    """The generic loop's static buffers for one lane count, and
    ``_Solver._iterate`` on them captured as one CUDA graph: the loop state
    (``_start``), ``aux`` (the run's second moments or pinned messages) and
    a twin of the model whose every tensor field (buffers, per-lane
    hyperparameters) is a buffer of the plan; each solve copies its own in
    (``load``). A replay runs the same kernels with the same arguments in
    the same order as the eager iteration, so it gives the same bits.

    The first ``step`` runs its iteration eagerly on a side stream, then
    captures the next one (``graphs``). A capture that raises (a factor
    whose message reads the device from the host) leaves ``failed`` set,
    and the steps of that solve run eagerly on the buffers."""

    def __init__(self, solver, model, aux, state, B, tol, signature):
        self.signature = signature
        self.graph = None
        self.failed = False
        self.counts = []
        self.B, self.tol = B, tol
        self.model = with_buffers(model, {
            (i, name): getattr(f, name).clone()
            for i, f in enumerate(model.factors) for name in _copied(f)})
        self.aux = map_tree(torch.clone, aux)
        self.loop = solver._start(state, B)

    def load(self, solver, model, aux, state):
        """Copy a solve's inputs in: the tensor fields of ``model``, its
        ``aux`` and its initial ``state``; the stop metric from them, and
        the flags zeroed. Returns the loop state, the plan's own."""
        for f, mine in zip(model.factors, self.model.factors):
            for name in _copied(f):
                getattr(mine, name).copy_(getattr(f, name))
        for mine, theirs in zip(graphs.leaves(self.aux), graphs.leaves(aux)):
            mine.copy_(theirs)
        for mine, theirs in zip(self.loop["state"], state):
            for k in mine:
                mine[k].copy_(theirs[k])
        metric = solver.engine._metric(state, solver.stop_kind)
        for mine, theirs in zip(self.loop["metric"], metric):
            mine.copy_(theirs)
        torch._foreach_zero_(list(self.loop["flags"].values()))
        return self.loop

    def step(self, solver):
        """One iteration: a replay of the graph; before the graph, the
        capture; after a capture that failed, the eager iteration."""
        if self.graph is not None:
            graphs.replay(self.graph, self.counts)
        elif self.failed:
            self._iterate(solver)
        else:
            with trace.span("capture"):
                self._capture(solver)

    def _iterate(self, solver):
        solver._iterate(self.model, self.aux, self.B, self.loop, self.tol)

    def _capture(self, solver):
        "This iteration eagerly on a side stream, then the capture."
        graphs.warm(lambda: self._iterate(solver))
        self.graph, self.counts = graphs.capture(
            lambda: self._iterate(solver))
        self.failed = self.graph is None

    def release(self):
        "Drop the buffers and the graph; the signature stays, as failed."
        self.model = self.aux = self.loop = self.graph = None


def _write(old, new, flag):
    """``new`` written into ``old`` where the loop flag ``flag`` is set; the
    state a sweep emits has the layout of the state it read
    (``MessagePassing._harmonize_state``)."""
    flag = flag.reshape(flag.shape + (1,) * (old.ndim - flag.ndim))
    torch.where(flag, new, old, out=old)


def _copied(factor):
    """The names of ``factor``'s tensor fields that a ``_Plan`` holds and
    each solve copies in: its buffers and per-lane hyperparameters."""
    return [name for name in list(factor._buffers) + hyperparameters(factor)
            if isinstance(getattr(factor, name, None), torch.Tensor)]


def _layout(t):
    "A tensor's shape, strides, dtype and device."
    return (tuple(t.shape), t.stride(), t.dtype, t.device)


def _value(v, copied):
    """A field as a signature compares it: a tensor a plan copies in by its
    layout, another tensor by its layout and storage, an array by its
    bytes, anything else as it is."""
    if isinstance(v, torch.Tensor):
        return _layout(v) if copied else (_layout(v), v.data_ptr())
    if isinstance(v, np.ndarray):
        return (v.shape, v.dtype.str, v.tobytes())
    return v
