"""Message-passing engine base. Counterpart of
tramp_tpu/algos/message_passing.py.

- Message state is a tuple of per-directed-edge dicts
  ``{"a": tensor, "b": tensor}`` (``a`` is 0-d for isotropic messages,
  ``b`` has the variable's shape; the state evolution keeps ``a`` alone),
  followed by one dict holding the spectral-image cache when the engine
  carries one.
- One iteration is a forward + backward sweep over the static schedule
  (``_sweep``); ``iterate`` runs it in a Python loop with the semantics of
  the JAX package's compiled ``while_loop``, reading the stop flags from
  the device once per sweep; with ``callback=`` it runs the JAX package's
  Python loop, in which the callback sees the live engine after every sweep
  and decides when to stop.
- NaN guard: if a sweep produces any non-finite message the previous state
  is kept and the loop stops (reference message_passing.py:187-209).
- Damping: constant per-edge factor->variable damping
  ``new = d*old + (1-d)*new`` (reference message_passing.py:119-127), or
  ``damping="adaptive"``: Bethe-objective backtracking on every slot write
  (reference message_passing.py:151-185), branchless, so it runs in both
  loops without a host read.
- ``update_dA=True`` records each slot write's local Bethe change in
  ``self.dA``; ``run_trace`` stacks the mean posterior variances of a fixed
  number of sweeps on the device; ``save_state`` / ``load_state`` persist
  the state in the JAX package's ``.npz`` layout, so a checkpoint of either
  package resumes in the other.
- ``config.STATE_BF16``: float32 ``b`` messages are stored as bfloat16
  (``_store_msg``, after damping) and upcast at every read (``_load_msg``),
  so all arithmetic stays float32 (tramp_tpu/algos/message_passing.py:278-300).
- ``config.PIN_CONSTANT_MESSAGES``: the slots of factors whose message is a
  model constant, and the variable cavities that sum only such slots, are
  pinned (``pinned``): written with their constant at the top of every
  sweep, never damped (tramp_tpu/algos/message_passing.py:81-160). Their
  values are computed once per run (``_pinned_slots``).

Slot layout: model edge e gets slots 2e (direction "fwd") and 2e+1 ("bwd").

Lanes (tramp_tpu_torch/lanes.py): a state whose messages carry a first lane
axis (``b`` of shape ``(B, n)``, ``a`` of shape ``(B, 1)``) is swept by the
same code against a model whose buffers carry lanes, and ``_metric``,
``_delta_increase`` and ``_all_finite`` then return one value per lane,
shape ``(B,)``. ``iterate`` solves one instance; the batched loop is
``parallel.EPSolver``.
"""
import numpy as np
import torch

from .. import config
from ..base import Variable, Factor
from ..lanes import lane_count, per_lane
from ..models import Model
from .callbacks import EarlyStopping, EarlyStoppingEP
from .initial_conditions import ConstantInit

FWD, BWD = 0, 1


def slot(e, direction):
    return 2 * e + direction


class MessagePassing:

    #: Increase-rollback (reference EarlyStopping, callbacks.py:195-243):
    #: when the convergence metric increases by more than
    #: ``rollback_increase`` after ``wait_increase`` iterations, revert to
    #: the previous state and stop.
    rollback_increase = None
    wait_increase = 5

    #: SE messages are scalar precisions: no variable shapes are required,
    #: so SE-only factors skip shape propagation (the reference builds SE
    #: GLMs with size=None, generalized_linear_model.py:45)
    needs_shapes = True

    #: Engines whose sweep prints concrete values (the explain wrappers)
    #: keep the raw init: the shape sweeps on meta tensors would print.
    harmonize = True

    def __init__(self, model, message_keys):
        if not isinstance(model, Model):
            raise ValueError(f"model {model} is not a Model")
        self.model = model
        self.message_keys = message_keys
        self.n_iter = 0
        self.state = None
        self.A_model = None

        # static schedule ------------------------------------------------
        self.nodes = model.nodes
        self.edges = model.edges
        self.n_slots = 2 * len(model.edges)
        # variable node index adjacent to each edge
        self.edge_variable = [
            ui if isinstance(model.nodes[ui], Variable) else vi
            for (ui, vi) in model.edges
        ]
        # factor-emitted slots (fwd on factor->var edges, bwd on var->factor)
        self.factor_emitted = [
            slot(e, FWD) if isinstance(model.nodes[ui], Factor)
            else slot(e, BWD)
            for e, (ui, vi) in enumerate(model.edges)
        ]
        self.variable_indices = [
            i for i, n in enumerate(self.nodes) if isinstance(n, Variable)]
        # pinned (constant) slots: slot -> factor node index, and slot ->
        # the pinned factor slots its cavity sums
        self.pinned_factor = {}
        self.pinned_variable = {}
        if config.pin_constant_messages():
            self._init_pinned_slots()
        self.pinned = (frozenset(self.pinned_factor)
                       | frozenset(self.pinned_variable))
        # the node updates of a sweep whose every message is pinned, (node
        # index, direction): skipped, since their result would be dropped
        self._pinned_updates = frozenset(
            (i, d) for i in range(len(self.nodes)) for d in (FWD, BWD)
            if self._emitted(i, d)
            and all(s in self.pinned for s in self._emitted(i, d)))
        # factor node indices whose spectral image is carried in the state
        self.spectral_factors = tuple(self._init_spectral_factors())
        self._spectral = frozenset(self.spectral_factors)

    def _init_spectral_factors(self):
        "Engine hook: factor indices that carry a spectral image. Default: none."
        return ()

    # -- pinned (constant) slots ------------------------------------------
    def _init_pinned_slots(self):
        """The slots of the factors whose emitted message is a model
        constant (``_constant_factor_message``), and the variable cavities
        whose contributors are all such slots."""
        for i, node in enumerate(self.nodes):
            if isinstance(node, Variable):
                continue
            if node.n_next == 0 and self._constant_factor_message(node):
                for e in self.model.in_edges[i]:
                    self.pinned_factor[slot(e, BWD)] = i
            if node.n_prev == 0 and self._constant_factor_message(node):
                for e in self.model.out_edges[i]:
                    self.pinned_factor[slot(e, FWD)] = i
        for i, node in enumerate(self.nodes):
            if not isinstance(node, Variable):
                continue
            in_slots = self._in_slots(i)
            targets = ([(slot(e, BWD), slot(e, FWD))
                        for e in self.model.out_edges[i]]
                       + [(slot(e, FWD), slot(e, BWD))
                          for e in self.model.in_edges[i]])
            for excluded, out_slot in targets:
                contrib = [s for s in in_slots if s != excluded]
                if contrib and all(s in self.pinned_factor
                                   for s in contrib):
                    self.pinned_variable[out_slot] = tuple(contrib)

    def _constant_factor_message(self, node):
        "Engine hook: True when ``node``'s emitted message is model-constant."
        return False

    def _emitted(self, i, direction):
        "The slots node i writes in the pass of ``direction``."
        if direction == FWD:
            return [slot(e, FWD) for e in self.model.out_edges[i]]
        return [slot(e, BWD) for e in self.model.in_edges[i]]

    def _pinned_values(self, model):
        """{slot: message} for every pinned slot, computed from ``model``:
        the factors' constants, then the variable cavities that sum them."""
        out = {}
        for s, i in self.pinned_factor.items():
            out[s] = self._factor_constant_message(model, i)
        for s, contrib in self.pinned_variable.items():
            out[s] = {key: sum(out[c][key] for c in contrib)
                      for key in self.message_keys}
        return out

    def _pinned_slots(self, model, state, aux):
        """The pinned slots' messages as the state holds them: each value
        broadcast to its slot's shape and dtype and stored (``_store_msg``).
        A run computes them once, at its first sweep, and keeps them in its
        ``aux`` (the dict ``_prepare`` gives)."""
        if "pinned" not in aux:
            kept = {}
            for s, msg in self._pinned_values(model).items():
                old = self._load_msg(state[s])
                kept[s] = self._store_msg({
                    k: torch.broadcast_to(
                        torch.as_tensor(v, dtype=old[k].dtype,
                                        device=old[k].device),
                        old[k].shape).contiguous()
                    for k, v in msg.items()})
            aux["pinned"] = kept
        return aux["pinned"]

    # -- bf16 state storage (config.STATE_BF16) ---------------------------
    @staticmethod
    def _store_msg(msg):
        """``msg`` as the state stores it: with ``config.STATE_BF16`` a
        float32 ``b`` becomes bfloat16; ``a`` and float64 stay."""
        if not config.state_bf16():
            return msg
        return {k: v.to(torch.bfloat16)
                if k == "b" and v.dtype == torch.float32 else v
                for k, v in msg.items()}

    @staticmethod
    def _load_msg(msg):
        "A stored message with every bfloat16 array upcast to float32."
        if not any(v.dtype == torch.bfloat16 for v in msg.values()):
            return msg
        return {k: v.float() if v.dtype == torch.bfloat16 else v
                for k, v in msg.items()}

    def _prepare(self, model):
        """Auxiliary data of a run that the sweeps share (the second moments
        for SE, the pinned messages for EP), computed once per run from the
        model that is swept."""
        return None

    def _fill_aux(self, model, state, aux):
        """``aux`` (``_prepare(model)``) with what the first sweep of a run
        from ``state`` would add to it computed now: the pinned slots'
        messages. The batched loop fills it before its first iteration, so
        that an iteration only reads it (a captured iteration cannot add
        to it). Returns ``aux``."""
        if self.pinned:
            self._pinned_slots(model, state, aux)
        return aux

    def device_dtype(self):
        "Device and dtype of the message state."
        return self.model.device_dtype()

    # -- initial state ---------------------------------------------------
    def init_state(self, initializer=None):
        initializer = initializer or ConstantInit(a=0, b=0)
        shapes = self.model.init_shapes() if self.needs_shapes else {}
        device, dtype = self.device_dtype()
        state = []
        for e in range(len(self.edges)):
            v_idx = self.edge_variable[e]
            var = self.nodes[v_idx]
            for dname in ("fwd", "bwd"):
                state.append({
                    key: initializer.init(key, shapes.get(v_idx), var.id,
                                          dname, device, dtype)
                    for key in self.message_keys})
        if self.spectral_factors:
            # placeholders of the image's shape, k or (k, K) for a variable
            # with a trailing K axis; the refresh below fills them
            state.append({
                str(i): torch.zeros(
                    (self.nodes[i].k,)
                    + tuple(shapes[self._out_variable(i)][1:]),
                    device=device, dtype=dtype)
                for i in self.spectral_factors})
        state = tuple(state)
        if self.needs_shapes and self.harmonize:
            state = self._harmonize_state(state)
        if self.spectral_factors:
            # the cache must equal U^T bx0 of the initialized slots (the
            # value the uncached engine's first forward pass computes)
            state = self._refresh_spectral_cache(state)
        return state

    def _refresh_spectral_cache(self, state, model=None):
        """Recompute each carried spectral image from the current slots,
        with the operators of ``model`` (None: the engine's own; the batched
        solver passes the model whose buffers carry the lanes)."""
        nodes = self.nodes if model is None else model.nodes
        cache = {}
        for i in self.spectral_factors:
            msg = self._load_msg(state[slot(self.model.out_edges[i][0], BWD)])
            cache[str(i)] = nodes[i].spectral_image(msg["b"], msg["a"])
        return tuple(state[:self.n_slots]) + (cache,)

    def _out_variable(self, i):
        "Node index of the variable on factor i's (one) out edge."
        return self.edge_variable[self.model.out_edges[i][0]]

    def _harmonize_state(self, state):
        """Broadcast each slot's init values to the shapes and dtypes a sweep
        emits (tramp_tpu/algos/message_passing.py:215-250). The shapes come
        from two sweeps over the model's meta copy, which compute nothing."""
        def meta(t):
            return torch.empty_like(t, device="meta")

        meta_state = tuple(
            {k: meta(v) for k, v in msg.items()} for msg in state)
        damp = (0.0,) * self.n_slots
        meta_model = self.model.to_meta()
        out = self._sweep(meta_model, meta_state, damp)
        out = self._sweep(meta_model, out, damp)

        def like(x, tgt):
            return torch.broadcast_to(x.to(tgt.dtype), tgt.shape).contiguous()

        return tuple(
            {k: like(msg[k], out_msg[k]) for k in msg}
            for msg, out_msg in zip(state, out))

    # -- damping ---------------------------------------------------------
    def _damping_per_slot(self, damping):
        "Per-slot damping coefficients (0 = undamped)."
        damp = [0.0] * self.n_slots
        if not damping:
            return tuple(damp)
        if isinstance(damping, float):
            for e in range(len(self.edges)):
                damp[self.factor_emitted[e]] = damping
            return tuple(damp)
        if isinstance(damping, list):
            # damp the factor->variable message with direction `direction`
            # arriving at variable `id` (reference configure_damping l:70-106)
            for (id, direction, d) in damping:
                v_idx = self.model.variable_index(id)
                want_dir = FWD if direction == "fwd" else BWD
                for e, (ui, vi) in enumerate(self.edges):
                    if self.edge_variable[e] != v_idx:
                        continue
                    if want_dir == FWD and isinstance(self.nodes[ui], Factor):
                        damp[slot(e, FWD)] = d
                    if want_dir == BWD and isinstance(self.nodes[vi], Factor):
                        damp[slot(e, BWD)] = d
            return tuple(damp)
        raise ValueError("damping must be None, float or list")

    # -- node processing -------------------------------------------------
    def _in_slots(self, i):
        return ([slot(e, FWD) for e in self.model.in_edges[i]]
                + [slot(e, BWD) for e in self.model.out_edges[i]])

    def _variable_out(self, i, state, direction):
        """Cavity messages from variable node i: for each out adjacency, sum
        all incoming messages except the opposite-direction message on that
        same adjacency (cancellation-free, reference base.py:183-207)."""
        in_slots = self._in_slots(i)
        if direction == FWD:
            targets = [(e, slot(e, BWD)) for e in self.model.out_edges[i]]
        else:
            targets = [(e, slot(e, FWD)) for e in self.model.in_edges[i]]
        loaded = {s: self._load_msg(state[s]) for s in in_slots}
        return {
            slot(e, direction): {
                key: sum(loaded[s][key] for s in in_slots if s != excluded)
                for key in self.message_keys}
            for e, excluded in targets}

    def _gather(self, i, state):
        """The messages into factor i: (from its inputs, from its outputs),
        each a list in the model's edge order."""
        return ([self._load_msg(state[slot(e, FWD)])
                 for e in self.model.in_edges[i]],
                [self._load_msg(state[slot(e, BWD)])
                 for e in self.model.out_edges[i]])

    def _posterior(self, i, state):
        loaded = [self._load_msg(state[s]) for s in self._in_slots(i)]
        return {key: sum(m[key] for m in loaded) for key in self.message_keys}

    # -- adaptive damping and the local Bethe change --------------------------
    def _msg_target(self, s):
        "Node index receiving the message in slot s."
        e, d = divmod(s, 2)
        ui, vi = self.edges[e]
        return vi if d == FWD else ui

    def _edge_objective(self, e, state, aux=None):
        "Edge term of the Bethe objective: variable objective of fwd+bwd."
        v_idx = self.edge_variable[e]
        msgs = [self._load_msg(state[slot(e, FWD)]),
                self._load_msg(state[slot(e, BWD)])]
        post = {k: sum(m[k] for m in msgs) for k in self.message_keys}
        return self.variable_objective(self.nodes[v_idx], v_idx, post, aux)

    def _local_objective(self, state, s, msg, aux=None):
        """The part of the Bethe objective that slot s's message moves: the
        objective of the node it goes to less its edge term, with ``msg``
        in slot s. ``aux`` is the sweep's ``_prepare(model)``."""
        st = list(state)
        st[s] = msg
        return (self.node_objective_at(self._msg_target(s), st, aux)
                - self._edge_objective(s // 2, st, aux))

    def _adaptive_update(self, state, s, new_msg, is_first, aux=None,
                         n_max=10):
        """Bethe-objective backtracking: accept new = old + beta*(new-old)
        with the largest beta in {1, 1/2, ..., 1/2^(n_max-1)} for which the
        local objective change dA >= 0; keep old otherwise (reference
        message_passing.py:151-185). The first sweep is undamped."""
        if is_first:
            return new_msg
        old = self._load_msg(state[s])
        A_old = self._local_objective(state, s, old, aux)
        accepted = old
        # smallest beta first, so that the largest beta with dA >= 0 wins:
        # the reference's first accept from beta = 1 down, with no host read
        for n in reversed(range(n_max)):
            beta = 0.5**n
            cand = {k: old[k] + beta * (new_msg[k] - old[k])
                    for k in self.message_keys}
            ok = self._local_objective(state, s, cand, aux) - A_old >= 0
            accepted = {k: torch.where(ok, cand[k], accepted[k])
                        for k in self.message_keys}
        return accepted

    def _edge_dA(self, state, s, new_msg, aux=None):
        """Local Bethe objective change of writing new_msg into slot s
        (reference compute_dA, message_passing.py:129-149)."""
        return (self._local_objective(state, s, new_msg, aux)
                - self._local_objective(state, s, self._load_msg(state[s]),
                                        aux))

    def _sweep(self, model, state, damp, aux=None, adaptive=False,
               is_first=False, update_dA=False):
        """One forward + backward sweep of ``model`` (the engine's model or
        its meta copy) from ``state``; ``aux`` is ``_prepare(model)``.
        ``adaptive``: Bethe backtracking on every slot write in place of
        ``damp`` (undamped when ``is_first``). Returns the new state tuple,
        and with ``update_dA`` also ``{slot: local Bethe change}`` (0-d
        tensors). Pinned slots are written with their constants first and
        then left alone; every write is stored through ``_store_msg``."""
        state = list(state)
        if self.spectral_factors:
            # local cache copy at index n_slots; spectral factor reads go
            # through state[self.n_slots], writes through ("spec", key)
            cache = dict(state[self.n_slots])
            state[self.n_slots] = cache
        dA = {}
        if self.pinned:
            if aux is None:
                aux = self._prepare(model)
            for s, msg in self._pinned_slots(model, state, aux).items():
                state[s] = msg

        def write(updates):
            for s, msg in updates.items():
                if isinstance(s, tuple):
                    # ("spec", key): the carried spectral image, a derived
                    # quantity, never damped, no part of the objective
                    cache[s[1]] = msg
                    continue
                if s in self.pinned:
                    # set at the top of the sweep, never damped; its local
                    # Bethe change is 0
                    if update_dA:
                        dA[s] = state[s]["a"].new_zeros(())
                    continue
                if adaptive:
                    msg = self._adaptive_update(state, s, msg, is_first,
                                                aux)
                else:
                    d = damp[s]
                    if d:
                        old = self._load_msg(state[s])
                        msg = {k: d * old[k] + (1.0 - d) * msg[k]
                               for k in self.message_keys}
                if update_dA:
                    dA[s] = self._edge_dA(state, s, msg, aux)
                state[s] = self._store_msg(msg)

        def update(i, node, direction):
            if (i, direction) in self._pinned_updates:
                # every message it writes is pinned: its local Bethe
                # change is 0
                if update_dA:
                    for s in self._emitted(i, direction):
                        dA[s] = state[s]["a"].new_zeros(())
            elif isinstance(node, Variable):
                write(self._variable_out(i, state, direction))
            elif direction == FWD:
                write(self._factor_forward(i, node, state, aux))
            else:
                write(self._factor_backward(i, node, state, aux))

        # forward pass
        for i, node in enumerate(model.nodes):
            if node.n_next:
                update(i, node, FWD)
        # backward pass
        for i in reversed(range(len(model.nodes))):
            if model.nodes[i].n_prev:
                update(i, model.nodes[i], BWD)
        if update_dA:
            return tuple(state), dA
        return tuple(state)

    # -- convergence metrics ----------------------------------------------
    def _lanes(self, state):
        "B when the state's messages carry a lane axis, else None."
        return lane_count(state[0]["a"], state[0]["b"])

    def _metric(self, state, kind):
        """Per-variable stopping metric: posterior v (kind="v", reference
        EarlyStopping; 0-d, or ``(B,)`` with lanes) or posterior r
        (kind="r", reference EarlyStoppingEP; the variable's shape).
        """
        lanes = self._lanes(state)
        out = []
        for i in self.variable_indices:
            post = self._posterior(i, state)
            if kind == "v":
                v = 1.0 / post["a"]
                out.append(per_lane(v, True).mean(-1) if lanes
                           else torch.mean(v))
            else:
                # NaN-free also on the a=0, b=0 init state
                a = post["a"]
                tiny = torch.finfo(a.dtype).tiny
                out.append(post["b"] / torch.clamp(a, min=tiny))
        return out

    def _delta_increase(self, kind, new_m, old_m, lanes=None):
        """(convergence delta, divergence measure) for the chosen metric:
        kind="v": max |dv| and max dv (callbacks.py:220-236);
        kind="r": max relative r change, used for both (callbacks.py:265-277).
        The maximum is over the variables; with ``lanes`` both come back
        per lane, shape ``(B,)``.
        """
        if kind == "v":
            # one mean variance per variable (and lane): nothing to reduce
            # within a variable
            deltas = torch.stack(
                [torch.abs(n - o) for n, o in zip(new_m, old_m)])
            incs = torch.stack([n - o for n, o in zip(new_m, old_m)])
            return deltas.amax(0), incs.amax(0)

        def norm(x):
            if lanes:
                return torch.sqrt(per_lane(x**2, True).mean(-1))
            return torch.sqrt(torch.mean(x**2))

        def rel(n, o):
            # finfo.tiny keeps the division guard live in every dtype
            nn = norm(n)
            return norm(n - o) / torch.clamp(nn, min=torch.finfo(nn.dtype).tiny)

        d = torch.stack([rel(n, o) for n, o in zip(new_m, old_m)]).amax(0)
        return d, d

    def _stop_params(self, early_stop, tol):
        """(metric kind, tol, wait_increase, max_increase) from an
        EarlyStopping/EarlyStoppingEP or the engine default."""
        if early_stop is None:
            return (self.default_stop_kind, tol, self.wait_increase,
                    self.rollback_increase)
        if not isinstance(early_stop, (EarlyStopping, EarlyStoppingEP)):
            raise ValueError(f"early_stop must be EarlyStopping or "
                             f"EarlyStoppingEP, got {early_stop}")
        return (early_stop.kind, early_stop.tol, early_stop.wait_increase,
                early_stop.max_increase)

    # -- finite guard -----------------------------------------------------
    def _all_finite(self, state):
        "One flag; with lanes one per lane, shape ``(B,)``."
        arrays = [self._load_msg(msg)[k]
                  for msg in state[:self.n_slots] for k in self.message_keys]
        if self.spectral_factors:
            arrays += list(state[self.n_slots].values())
        if self._lanes(state):
            # array by array: one concatenated copy of a batched state
            # would move every message once more
            flags = [torch.isfinite(per_lane(x, True)).all(-1)
                     for x in arrays]
            return torch.stack(flags).all(0)
        return torch.isfinite(
            torch.cat([x.reshape(-1) for x in arrays])).all()

    # -- iterate ----------------------------------------------------------
    def iterate(self, max_iter=200, callback=None, initializer=None,
                damping=None, warm_start=False, tol=1e-6, check_nan=True,
                early_stop=None, update_dA=False):
        """Run message passing until the stop rule fires or ``max_iter``
        sweeps have run.

        With a ``callback`` (or ``update_dA=True``) the loop is the JAX
        package's Python loop (message_passing.py:610-630): after every
        finite sweep the engine's state and ``n_iter`` are brought up to
        date and ``callback(self, i, max_iter)`` is called, which may read
        the engine, put back an earlier state and stop the loop by returning
        true; a sweep that is not finite ends the loop and is dropped.
        ``tol``, ``early_stop`` and ``check_nan`` belong to the loop without
        callback. ``update_dA=True`` records each slot write's local Bethe
        change as ``self.dA = {slot: float}`` after every sweep (one host
        read of all slots).

        Without one the loop follows the JAX package's compiled ``while_loop``
        (tramp_tpu/algos/message_passing.py:631-680): a sweep whose state is
        not all finite is dropped and stops the loop; ``converged`` is
        ``(i > 0) & (delta < tol)``; the divergence rollback keeps the
        previous state and stops when ``i > wait_increase`` and the metric
        grew by more than ``max_increase``. ``early_stop`` may be an
        EarlyStopping/EarlyStoppingEP to override the engine's default rule.

        ``damping`` is None, a float, a list of ``(id, direction, d)`` or
        ``"adaptive"`` (Bethe backtracking, in either loop; the first sweep
        of a run from the initial state is undamped).
        """
        if warm_start:
            if self.state is None:
                raise ValueError("message state was never initialized")
        else:
            self.state = self.init_state(initializer)
            self.n_iter = 0
        adaptive = damping == "adaptive"
        damp = self._damping_per_slot(None if adaptive else damping)
        aux = self._prepare(self.model)
        if callback is not None or update_dA:
            callback = callback or (lambda algo, i, max_iter: False)
            return self._iterate_python(max_iter, damp, callback, aux,
                                        adaptive, update_dA)
        kind, tol, wait_increase, max_increase = self._stop_params(
            early_stop, tol)

        state = self.state
        if self.spectral_factors:
            state = self._refresh_spectral_cache(state)
        old_m = self._metric(state, kind)
        i = 0
        while i < max_iter:
            new_state = self._sweep(self.model, state, damp, aux, adaptive,
                                    self.n_iter + i == 0)
            new_m = self._metric(new_state, kind)
            delta, inc = self._delta_increase(kind, new_m, old_m)
            true = torch.ones((), dtype=torch.bool, device=delta.device)
            ok = self._all_finite(new_state) if check_nan else true
            grew = inc > max_increase if max_increase is not None else ~true
            # the one host sync of the sweep
            small, ok, grew = torch.stack([delta < tol, ok, grew]).tolist()
            rollback = i > wait_increase and grew
            if ok and not rollback:
                state, old_m = new_state, new_m
            i += 1
            if not ok or rollback or (i > 1 and small):
                break
        self.state = state
        self.n_iter += i
        return self

    def _iterate_python(self, max_iter, damp, callback, aux, adaptive=False,
                        update_dA=False):
        if self.spectral_factors:
            self.state = self._refresh_spectral_cache(self.state)
        for i in range(max_iter):
            new_state = self._sweep(self.model, self.state, damp, aux,
                                    adaptive, self.n_iter == 0, update_dA)
            if update_dA:
                new_state, dA = new_state
                # per-slot local Bethe change, keyed like get_edges_data
                self.dA = dict(zip(
                    dA, torch.stack(list(dA.values())).tolist()))
            if not bool(self._all_finite(new_state)):
                break
            self.state = new_state
            self.n_iter += 1
            if callback(self, i, max_iter):
                break
        return self

    # -- on-device trace (JAX package message_passing.py:715-747) ----------
    def run_trace(self, n_iter=50, damping=None, initializer=None,
                  warm_start=False):
        """Run exactly ``n_iter`` sweeps, stacking each sweep's mean
        posterior variance of every variable on the device, and read the
        stack once at the end. Returns ``{variable id: (n_iter,) tensor}``
        on the CPU and advances the engine state and ``n_iter`` like
        ``iterate(warm_start=...)``. No stop rule and no finite guard, as in
        the JAX package's scan."""
        if warm_start:
            if self.state is None:
                raise ValueError("message state was never initialized")
        else:
            self.state = self.init_state(initializer)
            self.n_iter = 0
        damp = self._damping_per_slot(damping)
        aux = self._prepare(self.model)
        state = self.state
        if self.spectral_factors:
            state = self._refresh_spectral_cache(state)
        rows = []
        for _ in range(n_iter):
            state = self._sweep(self.model, state, damp, aux)
            rows.append(torch.stack(
                [torch.mean(v) for v in self._metric(state, "v")]))
        self.state = state
        self.n_iter += int(n_iter)
        if not rows:
            return {self.nodes[vi].id: torch.zeros(0)
                    for vi in self.variable_indices}
        # the one host read of the trace
        trace = torch.stack(rows).cpu()
        return {self.nodes[vi].id: trace[:, j]
                for j, vi in enumerate(self.variable_indices)}

    # -- checkpoint / resume (JAX package message_passing.py:749-788) ------
    # The layout is the JAX package's: ``__n_iter__``, ``s{slot}_{key}``
    # and ``spec_{factor index}`` for the carried spectral images, so a
    # checkpoint of either package resumes in the other.
    def save_state(self, path):
        "Persist the message state and iteration counter to ``path`` (.npz)."
        if self.state is None:
            raise ValueError("message state was never initialized")
        if any(v.dtype == torch.bfloat16
               for msg in self.state[:self.n_slots] for v in msg.values()):
            # the JAX package writes such a state as raw 2-byte records
            # that its own load_state cannot read back
            raise ValueError("save_state: the state holds bfloat16 messages "
                             "(config.STATE_BF16), which the .npz layout "
                             "does not round-trip; upcast them first")
        arrays = {"__n_iter__": np.asarray(self.n_iter)}
        for s, msg in enumerate(self.state[:self.n_slots]):
            for key in self.message_keys:
                arrays[f"s{s}_{key}"] = msg[key].detach().cpu().numpy()
        if self.spectral_factors:
            for k, v in self.state[self.n_slots].items():
                arrays[f"spec_{k}"] = v.detach().cpu().numpy()
        np.savez(path, **arrays)

    def load_state(self, path):
        """Restore a checkpoint written by ``save_state`` (of either
        package) onto the engine's device and dtype. Follow with
        ``iterate(..., warm_start=True)`` to resume. A checkpoint without
        the spectral images rebuilds them from the slots."""
        device, dtype = self.device_dtype()
        with np.load(path) as data:
            def load(name):
                return torch.as_tensor(data[name], device=device,
                                       dtype=dtype)
            state = tuple({key: load(f"s{s}_{key}")
                           for key in self.message_keys}
                          for s in range(self.n_slots))
            if self.spectral_factors:
                if f"spec_{self.spectral_factors[0]}" in data.files:
                    state += ({str(i): load(f"spec_{i}")
                               for i in self.spectral_factors},)
                else:
                    state = self._refresh_spectral_cache(state)
            n_iter = int(data["__n_iter__"])
        self.state = state
        self.n_iter = n_iter
        return self

    # -- data access (reference message_passing.py:265-304) ---------------
    def get_variables_data(self, ids="all"):
        data = {}
        for i in self.variable_indices:
            var = self.nodes[i]
            if ids == "all" or var.id in ids:
                post = self._posterior(i, self.state)
                data[var.id] = self.update(var, post)
        return data

    def get_variable_data(self, id):
        data = self.get_variables_data(ids=[id])
        if id not in data:
            raise ValueError(f"id={id} not in variables")
        return data[id]

    def get_edges_data(self, keys):
        records = []
        for e, (ui, vi) in enumerate(self.edges):
            var = self.nodes[self.edge_variable[e]]
            fac = (self.nodes[ui] if isinstance(self.nodes[ui], Factor)
                   else self.nodes[vi])
            for direction, dname in ((FWD, "fwd"), (BWD, "bwd")):
                msg = self._load_msg(self.state[slot(e, direction)])
                record = dict(x_id=var.id, f_id=fac.id, direction=dname)
                for key in keys:
                    if key in msg:
                        record[key] = msg[key].detach().cpu().numpy()
                records.append(record)
        return records

    # -- objective (Bethe free entropy, reference l:306-328) ---------------
    # Engines implement ``node_objective_at(i, state, aux=None)`` and
    # ``variable_objective(variable, node index, posterior, aux=None)``;
    # ``aux`` is ``_prepare(model)`` where the caller has it.
    def update_objective(self):
        A_nodes = 0.0
        for i in range(len(self.nodes)):
            A_nodes = A_nodes + self.node_objective_at(i, self.state)
        A_edges = 0.0
        for e in range(len(self.edges)):
            v_idx = self.edge_variable[e]
            msgs = [self._load_msg(self.state[slot(e, FWD)]),
                    self._load_msg(self.state[slot(e, BWD)])]
            post = {k: sum(m[k] for m in msgs) for k in self.message_keys}
            A_edges = A_edges + self.variable_objective(
                self.nodes[v_idx], v_idx, post)
        self.A_model = A_nodes - A_edges
        return self.A_model
