"""Message-passing engine base. Counterpart of
tramp_tpu/algos/message_passing.py (EP path).

- Message state is a tuple of per-directed-edge dicts
  ``{"a": tensor, "b": tensor}`` (``a`` is 0-d for isotropic messages,
  ``b`` has the variable's shape), followed by one dict holding the
  spectral-image cache when the engine carries one.
- One iteration is a forward + backward sweep over the static schedule
  (``_sweep``); ``iterate`` runs it in a Python loop with the semantics of
  the JAX package's compiled ``while_loop``, reading the stop flags from
  the device once per sweep.
- NaN guard: if a sweep produces any non-finite message the previous state
  is kept and the loop stops (reference message_passing.py:187-209).
- Damping: constant per-edge factor->variable damping
  ``new = d*old + (1-d)*new`` (reference message_passing.py:119-127).

Slot layout: model edge e gets slots 2e (direction "fwd") and 2e+1 ("bwd").
"""
import torch

from ..base import Variable, Factor
from ..models import Model
from .callbacks import EarlyStopping
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

    def __init__(self, model, message_keys):
        if not isinstance(model, Model):
            raise ValueError(f"model {model} is not a Model")
        self.model = model
        self.message_keys = message_keys
        self.n_iter = 0
        self.state = None

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
        # factor node indices whose spectral image is carried in the state
        self.spectral_factors = tuple(self._init_spectral_factors())
        self._spectral = frozenset(self.spectral_factors)

    def _init_spectral_factors(self):
        "Engine hook: factor indices that carry a spectral image. Default: none."
        return ()

    # -- initial state ---------------------------------------------------
    def init_state(self, initializer=None):
        initializer = initializer or ConstantInit(a=0, b=0)
        shapes = self.model.init_shapes()
        device, dtype = self.model.device_dtype()
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
            state.append({
                str(i): torch.zeros(self.nodes[i].k, device=device,
                                    dtype=dtype)
                for i in self.spectral_factors})
        state = self._harmonize_state(tuple(state))
        if self.spectral_factors:
            # the cache must equal U^T bx0 of the initialized slots (the
            # value the uncached engine's first forward pass computes)
            state = self._refresh_spectral_cache(state)
        return state

    def _refresh_spectral_cache(self, state):
        "Recompute each carried spectral image from the current slots."
        cache = {}
        for i in self.spectral_factors:
            e_out = self.model.out_edges[i][0]
            cache[str(i)] = self.nodes[i].spectral_image(
                state[slot(e_out, BWD)]["b"])
        return tuple(state[:self.n_slots]) + (cache,)

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
        return {
            slot(e, direction): {
                key: sum(state[s][key] for s in in_slots if s != excluded)
                for key in self.message_keys}
            for e, excluded in targets}

    def _posterior(self, i, state):
        in_slots = self._in_slots(i)
        return {key: sum(state[s][key] for s in in_slots)
                for key in self.message_keys}

    def _sweep(self, model, state, damp):
        """One forward + backward sweep of ``model`` (the engine's model or
        its meta copy) from ``state``. Returns the new state tuple."""
        state = list(state)
        if self.spectral_factors:
            # local cache copy at index n_slots; spectral factor reads go
            # through state[self.n_slots], writes through ("spec", key)
            cache = dict(state[self.n_slots])
            state[self.n_slots] = cache

        def write(updates):
            for s, msg in updates.items():
                if isinstance(s, tuple):
                    # ("spec", key): the carried spectral image, a derived
                    # quantity, never damped
                    cache[s[1]] = msg
                    continue
                d = damp[s]
                if d:
                    old = state[s]
                    msg = {k: d * old[k] + (1.0 - d) * msg[k]
                           for k in self.message_keys}
                state[s] = msg

        # forward pass
        for i, node in enumerate(model.nodes):
            if node.n_next == 0:
                continue
            if isinstance(node, Variable):
                write(self._variable_out(i, state, FWD))
            else:
                write(self._factor_forward(i, node, state))
        # backward pass
        for i in reversed(range(len(model.nodes))):
            node = model.nodes[i]
            if node.n_prev == 0:
                continue
            if isinstance(node, Variable):
                write(self._variable_out(i, state, BWD))
            else:
                write(self._factor_backward(i, node, state))
        return tuple(state)

    # -- convergence metrics ----------------------------------------------
    def _metric(self, state, kind):
        """Per-variable stopping metric: posterior v (kind="v", reference
        EarlyStopping) or posterior r (kind="r", reference EarlyStoppingEP).
        """
        out = []
        for i in self.variable_indices:
            post = self._posterior(i, state)
            if kind == "v":
                out.append(torch.mean(1.0 / post["a"]))
            else:
                # NaN-free also on the a=0, b=0 init state
                a = post["a"]
                tiny = torch.finfo(a.dtype).tiny
                out.append(post["b"] / torch.clamp(a, min=tiny))
        return out

    def _delta_increase(self, kind, new_m, old_m):
        """(convergence delta, divergence measure) for the chosen metric:
        kind="v": max |dv| and max dv (callbacks.py:220-236);
        kind="r": max relative r change, used for both (callbacks.py:265-277).
        """
        if kind == "v":
            deltas = torch.stack(
                [torch.max(torch.abs(n - o)) for n, o in zip(new_m, old_m)])
            incs = torch.stack(
                [torch.max(n - o) for n, o in zip(new_m, old_m)])
            return deltas.max(), incs.max()

        def norm(x):
            return torch.sqrt(torch.mean(x**2))

        def rel(n, o):
            # finfo.tiny keeps the division guard live in every dtype
            nn = norm(n)
            return norm(n - o) / torch.clamp(nn, min=torch.finfo(nn.dtype).tiny)

        d = torch.stack([rel(n, o) for n, o in zip(new_m, old_m)]).max()
        return d, d

    def _stop_params(self, early_stop, tol):
        """(metric kind, tol, wait_increase, max_increase) from an
        EarlyStopping/EarlyStoppingEP or the engine default."""
        if early_stop is None:
            return (self.default_stop_kind, tol, self.wait_increase,
                    self.rollback_increase)
        if not isinstance(early_stop, EarlyStopping):
            raise ValueError(f"early_stop must be EarlyStopping or "
                             f"EarlyStoppingEP, got {early_stop}")
        return (early_stop.kind, early_stop.tol, early_stop.wait_increase,
                early_stop.max_increase)

    # -- finite guard -----------------------------------------------------
    def _all_finite(self, state):
        flat = [msg[k].reshape(-1)
                for msg in state[:self.n_slots] for k in self.message_keys]
        if self.spectral_factors:
            flat += [v.reshape(-1) for v in state[self.n_slots].values()]
        return torch.isfinite(torch.cat(flat)).all()

    # -- iterate ----------------------------------------------------------
    def iterate(self, max_iter=200, initializer=None, damping=None,
                warm_start=False, tol=1e-6, check_nan=True, early_stop=None):
        """Run message passing until the stop rule fires or ``max_iter``
        sweeps have run.

        The loop follows the JAX package's compiled ``while_loop``
        (tramp_tpu/algos/message_passing.py:631-680): a sweep whose state is
        not all finite is dropped and stops the loop; ``converged`` is
        ``(i > 0) & (delta < tol)``; the divergence rollback keeps the
        previous state and stops when ``i > wait_increase`` and the metric
        grew by more than ``max_increase``. ``early_stop`` may be an
        EarlyStopping/EarlyStoppingEP to override the engine's default rule.
        """
        if warm_start:
            if self.state is None:
                raise ValueError("message state was never initialized")
        else:
            self.state = self.init_state(initializer)
            self.n_iter = 0
        damp = self._damping_per_slot(damping)
        kind, tol, wait_increase, max_increase = self._stop_params(
            early_stop, tol)

        state = self.state
        if self.spectral_factors:
            state = self._refresh_spectral_cache(state)
        old_m = self._metric(state, kind)
        i = 0
        while i < max_iter:
            new_state = self._sweep(self.model, state, damp)
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
