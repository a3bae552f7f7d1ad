"""ML-VAMP: the spectral fast path for arbitrary SISO chains. Counterpart
of tramp_tpu/parallel/ml_vamp.py.

Generalizes ``SpectralVAMPSolver`` (vamp_glm.py, exact 3-factor GLM chains)
to any single-input/single-output factor chain

    prior @ V @ F_1 @ V @ ... @ F_{L-1} @ V @ likelihood

covering the relu-net chain (multi-layer VAMP: Fletcher, Rangan, Schniter,
"Inference in Deep Networks in High Dimensions", 2018: the same
moment-matching fixed point as EP on a chain).

The solver runs the engine's serial forward/backward schedule with the
same moment matching, clipping and damping, and carries each dense linear
factor's spectral images across passes:

- forward pass: V^T bz (fresh) is computed, used, and kept for the
  backward pass (bz cannot change in between: the backward pass only
  writes backward slots);
- backward pass: U^T bx (fresh) is computed, used, and carried to the
  next sweep's forward pass (bx next changes in the next backward pass).

Per sweep that is 4 thin products per linear factor (2 Nz k + 2 Nx k MACs).

A terminal ``GaussianLikelihood`` is additionally pinned: its message is a
model constant (a = 1/var, b = y/var), so its slot is fixed from iteration
0 (instead of being damped toward the constant) and, when the preceding
factor is a dense ``LinearChannel``, its spectral image S U^T y / var is a
loop invariant and the linear factor's forward message is not materialized
inside the loop at all. Pinning changes the transient, not the fixed point.

Supported factors: any SISO channel/prior/likelihood with the standard
message contract (compute_forward_message / compute_backward_message);
``LinearChannel`` (exactly) gets the spectral treatment. Multi-edge
topologies are not chains: use ``EPSolver``. ``dispatch_solver`` picks.

The loop, its flags and frozen lanes, and its replay as a CUDA graph on
the card (one launch where the eager iteration makes about 260) are
``parallel/loop.py``'s. Its iteration here (``MLVAMPSolver._iterate``): the
step, then its finish (``ops.ml_vamp_finish``: the finite test, the frozen
lanes and the stop metric, one hand-written kernel on the card); a step
that is not finite is dropped and ends its lane. A plan copies in the
terminal factor's tensors (the observation) and the loop invariants; the
other factors' tensors (W and its SVD factors) are read where they lie, so
a model whose operator moved is captured again.
"""
import torch

from ..base import compute_ab_new
from ..channels import LinearChannel
from ..lanes import lane_count, lane_values, model_lanes
from ..likelihoods import GaussianLikelihood
from ..ops.ml_vamp_finish import ml_vamp_finish, ratio
from .loop import SolverLoop, start_flags, tensor_fields
from .mesh import map_tree, whole_batch


def chain_factors(model):
    """The model's factors as a SISO chain [prior, F_1, ..., likelihood],
    or None if the model is not such a chain."""
    factors = list(model.factors)
    if len(factors) < 2:
        return None
    if not (factors[0].n_prev == 0 and factors[0].n_next == 1):
        return None
    if not (factors[-1].n_next == 0 and factors[-1].n_prev == 1
            and getattr(factors[-1], "y", None) is not None):
        return None
    for f in factors[1:-1]:
        if not (f.n_prev == 1 and f.n_next == 1):
            return None
    # interfaces must be plain SISO variables (one in-edge, one out-edge):
    # a SIMO/MISO variable means the DAG is a tree, not a chain
    for i, n in enumerate(model.nodes):
        if n in model.variables:
            if len(model.in_edges[i]) != 1 or len(model.out_edges[i]) != 1:
                return None
    return factors


def _is_spectral(f):
    "Dense LinearChannel exactly (not a subclass with another representation)."
    return type(f) is LinearChannel


def _lin_fwd(lin, az, bz, ax, tx):
    """Linear forward posterior using the carried spectral image
    tx = U^T bx; returns (rx, vx, tz) with tz = V^T bz (k-length) for the
    backward pass. Mirrors LinearChannel._mean_svd (thin factors; only the
    k signal modes reach x-space)."""
    lanes = lane_count(az, bz) is not None
    tz = lin._mm(lin.V, bz, transpose=True, lanes=lanes)        # (k,)
    resolvent = 1.0 / (az + ax * lin.s**2)
    m = resolvent * (tz + lin.s * tx)
    rx = lin._mm(lin.U, lin.s * m, lanes=lanes)
    vx = lin.compute_forward_variance(az, ax)
    return rx, vx, tz


def _lin_bwd(lin, az, bz, ax, tx, tz):
    "Linear backward posterior (rz, vz) from tx = U^T bx and tz = V^T bz."
    lanes = lane_count(az, bz) is not None
    resolvent = 1.0 / (az + ax * lin.s**2)
    m = resolvent * (tz + lin.s * tx)
    if lin.k == lin.Nz:
        rz = lin._mm(lin.V, m, lanes=lanes)
    else:
        # complement modes (s=0, resolvent 1/az):
        # V_perp V_perp^T bz / az = (bz - V_k tz) / az
        rz = bz / az + lin._mm(lin.V, m - tz / az, lanes=lanes)
    vz = lin.compute_backward_variance(az, ax)
    return rz, vz


class MLVAMPSolver(SolverLoop):
    """Spectral chain solver; same call surface as EPSolver and
    SpectralVAMPSolver: ``solve(model) -> ({id: {r, v}}, n_iter)``, and
    ``solve_batch`` on a model whose buffers carry lanes (a buffer has lanes
    when it has one axis more than the same buffer of the ``model`` the
    solver was built with, ``lanes.model_lanes``).

    ``damping`` mirrors the engine's float damping (applied to every
    factor-emitted message except pinned constants). The stopping rule is
    the engine's relative-r criterion over all chain interfaces. In float32
    that relative change has a rounding floor, which rises with the lanes
    that share an operator (their products are one float32 GEMM): 4e-7 for
    one instance and 1.5e-6 at 2048 lanes of the N = 4096 relu net on an
    NVIDIA H100 (chip_stop_floor.py), so a float32 batch wants
    ``tol=1e-5``, or ``EPSolver(stop_kind="v")``, where one instance
    converges at ``tol=1e-6``."""

    def __init__(self, model, damping=None, tol=1e-6, max_iter=200,
                 pin_terminal=True):
        factors = chain_factors(model)
        if factors is None:
            raise ValueError(
                f"MLVAMPSolver needs a SISO factor chain, got {model}")
        self.template = model
        self.tol = tol
        self.max_iter = max_iter
        self.damping = 0.0 if damping is None else float(damping)
        self.L = L = len(factors) - 1          # interfaces 0..L-1
        self.var_ids = list(model.variable_ids)
        self._linear = [_is_spectral(f) for f in factors]
        # terminal pin: constant likelihood message (Gaussian).
        # pin_terminal=False keeps the generic damped update instead, which
        # makes the iterate-by-iterate trajectory exactly the engine's; the
        # fixed point is the same either way.
        fn = getattr(factors[-1], "constant_backward_message", None)
        self._pin_terminal = (pin_terminal and fn is not None
                              and fn() is not None)
        # GLM tail: pinned Gaussian likelihood directly after a dense
        # linear factor -> the linear forward message is never consumed
        # inside the loop (the likelihood ignores it) and S U^T y / var is
        # loop-invariant
        self._skip_fwd_terminal = bool(
            L >= 2 and self._pin_terminal and self._linear[-2])
        # interface shapes for the zero init
        shapes = model.init_shapes()
        self._shapes = [shapes[i] for i, n in enumerate(model.nodes)
                        if n in model.variables]

    # -- loop invariants ---------------------------------------------------
    def _invariants(self, model, B=None):
        """What a step needs of the model and does not change in the loop:
        the pinned terminal message (b broadcast to the interface's shape,
        with the lanes; a one value, per lane with lanes) and, for the GLM
        tail, its spectral image U^T b."""
        inv = {"pin": None, "tx": None}
        if not self._pin_terminal:
            return inv
        lik = model.factors[-1]
        c = lik.constant_backward_message()
        lanes = () if B is None else (B,)
        shape = tuple(self._shapes[self.L - 1])
        inv["pin"] = {
            "a": c["a"].expand(
                lanes + (1,) * (len(shape) * len(lanes))).contiguous(),
            "b": torch.broadcast_to(c["b"], lanes + shape)}
        if self._skip_fwd_terminal:
            lin = model.factors[self.L - 1]
            inv["tx"] = lin._mm(lin.U, inv["pin"]["b"], transpose=True,
                                lanes=B is not None)
        return inv

    def _carry_lanes(self, carry):
        fb = carry[0][0]["fb"]
        return fb.shape[0] if fb.ndim > len(self._shapes[0]) else None

    def _damped(self, a_old, b_old, a_new, b_new):
        "Engine slot damping: d*old + (1-d)*new, after clipping."
        damp = self.damping
        if not damp:
            return a_new, b_new
        return (damp * a_old + (1.0 - damp) * a_new,
                damp * b_old + (1.0 - damp) * b_new)

    def _step(self, model, carry, inv=None):
        """One engine-identical sweep: forward pass then backward pass.
        carry = (msgs, txs); msgs[i] = {fa, fb, ba, bb} at interface i,
        txs[l] = U^T (backward b at factor l's x side) for linear l.

        A pinned terminal's (ba, bb) are not part of the carry: they come
        from ``inv`` (``_invariants(model)``, computed here when not given;
        the loop computes it once)."""
        L = self.L
        if inv is None:
            inv = self._invariants(model, self._carry_lanes(carry))
        factors = list(model.factors)
        msgs, txs = list(carry[0]), dict(carry[1])
        if self._pin_terminal:
            m = dict(msgs[L - 1])
            m["ba"], m["bb"] = inv["pin"]["a"], inv["pin"]["b"]
            msgs[L - 1] = m
        tzs = {}
        # ---- forward pass ----
        for l, f in enumerate(factors[:L]):
            m_out = dict(msgs[l])
            ax, bx = m_out["ba"], m_out["bb"]
            if l == 0:
                a_new, b_new = f.compute_forward_message(ax, bx)
            else:
                m_in = msgs[l - 1]
                az, bz = m_in["fa"], m_in["fb"]
                if self._linear[l]:
                    if l == L - 1 and self._skip_fwd_terminal:
                        # the pinned likelihood never reads this message;
                        # only cache tz for the backward pass
                        tzs[l] = f._mm(f.V, bz, transpose=True,
                                       lanes=lane_count(az, bz) is not None)
                        continue
                    rx, vx, tzs[l] = _lin_fwd(f, az, bz, ax, txs[str(l)])
                    a_new, b_new = compute_ab_new(rx, vx, ax, bx)
                else:
                    a_new, b_new = f.compute_forward_message(az, bz, ax, bx)
            m_out["fa"], m_out["fb"] = self._damped(
                m_out["fa"], m_out["fb"], a_new, b_new)
            msgs[l] = m_out
        # ---- backward pass ----
        for l in range(L, 0, -1):
            f = factors[l]
            m_out = dict(msgs[l - 1])
            az, bz = m_out["fa"], m_out["fb"]
            if l == L:
                if self._pin_terminal:
                    continue  # already pinned above
                a_new, b_new = f.compute_backward_message(az, bz)
            else:
                m_in = msgs[l]
                ax, bx = m_in["ba"], m_in["bb"]
                if self._linear[l]:
                    if l == L - 1 and self._skip_fwd_terminal:
                        # tx = U^T (y/var) is loop-invariant: no carry
                        tx = inv["tx"]
                    else:
                        tx = f._mm(f.U, bx, transpose=True,    # (k,)
                                   lanes=lane_count(ax, bx) is not None)
                        txs[str(l)] = tx
                    rz, vz = _lin_bwd(f, az, bz, ax, tx, tzs[l])
                    a_new, b_new = compute_ab_new(rz, vz, az, bz)
                else:
                    a_new, b_new = f.compute_backward_message(az, bz, ax, bx)
            m_out["ba"], m_out["bb"] = self._damped(
                m_out["ba"], m_out["bb"], a_new, b_new)
            msgs[l - 1] = m_out
        if self._pin_terminal:
            # keep the pinned constants out of the loop carry
            m = dict(msgs[L - 1])
            m.pop("ba"), m.pop("bb")
            msgs[L - 1] = m
        return (tuple(msgs), txs)

    def _sides(self, carry, inv):
        """(fa, ba, fb, bb) of every interface the stop metric reads: the
        carry's messages, the pinned terminal's from ``inv``; the forward
        slot the loop does not update is left out."""
        L = self.L
        pin = inv["pin"]
        out = []
        for i, m in enumerate(carry[0]):
            if i == L - 1 and self._skip_fwd_terminal:
                continue  # fwd slot not updated inside the loop
            if pin is not None and i == L - 1:
                out.append((m["fa"], pin["a"], m["fb"], pin["b"]))
            else:
                out.append((m["fa"], m["ba"], m["fb"], m["bb"]))
        return out

    def _metric(self, carry, inv):
        "Per-interface posterior means (the engine's 'r' stop metric)."
        return tuple(ratio(*side) for side in self._sides(carry, inv))

    def _init(self, model, B=None):
        """The zero carry, with B lanes; the scalar a-inits are broadcast to
        the shapes a sweep emits, which two steps over the model's meta copy
        give without computing anything."""
        L = self.L
        y = model.factors[-1].y
        kw = dict(dtype=y.dtype, device=y.device)
        lanes = () if B is None else (B,)
        msgs = []
        for i, shape in enumerate(self._shapes):
            shape = tuple(shape)
            a = torch.zeros(lanes + (1,) * (len(shape) * len(lanes)), **kw)
            m = {"fa": a, "fb": torch.zeros(lanes + shape, **kw),
                 "ba": a.clone(), "bb": torch.zeros(lanes + shape, **kw)}
            if self._pin_terminal and i == L - 1:
                # pinned slots live outside the carry (see _step)
                m.pop("ba"), m.pop("bb")
            msgs.append(m)
        txs = {}
        for l, f in enumerate(model.factors):
            if self._linear[l] and not (
                    l == L - 1 and self._skip_fwd_terminal):
                txs[str(l)] = torch.zeros(lanes + (f.k,), **kw)
        meta_model = model.to_meta()
        meta = (tuple({k: torch.empty_like(v, device="meta")
                       for k, v in m.items()} for m in msgs),
                {k: torch.empty_like(v, device="meta")
                 for k, v in txs.items()})
        out = self._step(meta_model, self._step(meta_model, meta))
        msgs = tuple(
            {k: torch.broadcast_to(m[k].to(o[k].dtype),
                                   o[k].shape).contiguous() for k in m}
            for m, o in zip(msgs, out[0]))
        return (msgs, txs)

    @staticmethod
    def _pairs(new, old):
        "(new leaf, old leaf) of two carries of one structure, key by key."
        for n, o in zip(new[0], old[0]):
            for k in o:
                yield n[k], o[k]
        for k in old[1]:
            yield new[1][k], old[1][k]

    def _prepare(self, model, carry):
        "The run's lane count, device, loop invariants and carry."
        B = model_lanes(model, self.template)
        return (B, model.factors[-1].y.device, self._invariants(model, B),
                carry)

    def _start(self, model, inv, B, carry):
        """The loop's state before its first iteration, which ``_iterate``
        updates in place: the zero carry, or a contiguous copy of ``carry``
        (the layout the finish's kernel writes), the posterior means and
        the flags."""
        carry = (self._init(model, B) if carry is None
                 else map_tree(lambda t: t.clone(
                     memory_format=torch.contiguous_format), carry))
        r = list(self._metric(carry, inv))
        return {"carry": carry, "metric": r,
                "flags": start_flags(B, r[0].device)}

    def _iterate(self, model, inv, B, loop, tol):
        """One iteration of the loop, in place on ``loop`` (``_start``):
        the sweep, then its finish (the finite test, the frozen lanes, the
        stop metric) and the flags, all on the device."""
        carry = loop["carry"]
        new = self._step(model, carry, inv)
        ml_vamp_finish(list(self._pairs(new, carry)), self._sides(carry, inv),
                       loop["metric"], loop["flags"], B, tol)

    def _copied(self, model):
        """What a plan copies in: the terminal factor's tensors; W and the
        other factors' tensors are read where they lie (copies would add
        their size to the peak memory)."""
        return tensor_fields(model, [len(model.factors) - 1])

    def _numbers(self):
        "What the iteration reads of the solver."
        return (self.damping, self._pin_terminal)

    def _readout(self, model, carry, inv, B):
        "Posterior {id: {r, v}} at every interface from the final state."
        L = self.L
        msgs = list(carry[0])
        if self._pin_terminal:
            # reconstitute the pinned slots (kept out of the loop carry)
            m = dict(msgs[L - 1])
            m["ba"], m["bb"] = inv["pin"]["a"], inv["pin"]["b"]
            msgs[L - 1] = m
        if self._skip_fwd_terminal:
            # materialize the one message the loop never needed: the
            # linear factor's forward posterior at the terminal interface
            lin = model.factors[L - 1]
            m_in = msgs[L - 2]
            m_out = dict(msgs[L - 1])
            ax, bx = m_out["ba"], m_out["bb"]
            rx, vx, _ = _lin_fwd(lin, m_in["fa"], m_in["fb"], ax, inv["tx"])
            m_out["fa"], m_out["fb"] = compute_ab_new(rx, vx, ax, bx)
            msgs[L - 1] = m_out
        post = {}
        for vid, m in zip(self.var_ids, msgs):
            a = m["fa"] + m["ba"]
            b = m["fb"] + m["bb"]
            post[vid] = {"r": b / a, "v": lane_values(1.0 / a, B)}
        return post

    def solve(self, model):
        "One instance: ({id: {r, v}}, n_iter)."
        post, _, n_iter, _ = self._run(model)
        return post, n_iter

    def solve_info(self, model):
        "Like solve, with the converged flag (True iff delta < tol fired)."
        post, _, n_iter, conv = self._run(model)
        return post, n_iter, conv

    def solve_batch(self, stacked_model, state=None):
        """Many instances in one loop: ``r`` comes back ``(B, n)``, ``v`` and
        ``n_iter`` ``(B,)``. The loop runs until every lane is done.
        Passing ``state`` (a carry as ``solve_batch_with_state`` returns
        it, or as ``parallel.restore_checkpoint`` restores it) resumes from
        it."""
        post, _, n_iter, _ = self._solve_batch(stacked_model, None, state)
        return whole_batch((post, n_iter), stacked_model)

    def solve_batch_with_state(self, stacked_model, state=None):
        """Like solve_batch but also returns the final carry with its
        lanes, for checkpoints (``parallel.save_checkpoint``) and warm
        restarts; the JAX package's MLVAMPSolver has no such call, its
        EPSolver has. On a sharded model (``parallel.shard_batched_model``)
        every rank returns the whole batch; ``state`` may hold the whole
        batch or this rank's lanes (``parallel.shard_batched_state``)."""
        post, carry, n_iter, _ = self._solve_batch(stacked_model, None, state,
                                                   own_carry=True)
        return whole_batch((post, carry, n_iter), stacked_model)

    def _solve_batch(self, stacked_model, initializer=None, state=None,
                     stop=None, own_carry=False):
        """The batched loop on this rank's lanes: (post, carry, n_iter,
        conv), not gathered. The loop starts from the zero carry or
        ``state``: it takes no initializer. ``own_carry``: ``_run``'s
        ``own``."""
        if initializer is not None:
            raise ValueError("MLVAMPSolver starts from the zero carry: no "
                             "initializer")
        if model_lanes(stacked_model, self.template) is None:
            raise ValueError("solve_batch: no buffer of the model has lanes")
        where = getattr(stacked_model, "mesh_lanes", None)
        if where is not None and state is not None:
            state = where.local(state)
        return self._run(stacked_model, state, stop, own=own_carry)


def dispatch_solver(model, damping=None, tol=1e-6, max_iter=200, **kw):
    """The production front door: route a model to the fastest solver that
    provably reaches the same fixed point.

    - exact 3-factor GLM chain (prior @ LinearChannel @ GaussianLikelihood)
      -> SpectralVAMPSolver (2 Nz k MACs per iteration on the thin factors);
    - any other supported SISO chain -> MLVAMPSolver (spectral-cached
      linear factors, pinned Gaussian likelihood);
    - anything else (trees, SIMO/MISO, multi-edge) -> the generic EPSolver.

    Returns the solver instance; all three share the
    ``solve(model) -> (post, n_iter)`` and ``solve_batch`` surface. Extra
    ``**kw`` are forwarded to whichever solver is selected: a keyword the
    selected solver does not accept raises TypeError (loud beats silently
    dropping e.g. ``pin_terminal`` or ``rollback_increase`` when the
    dispatch routes elsewhere than expected).
    """
    from .vamp_glm import SpectralVAMPSolver
    from .solver import EPSolver

    factors = chain_factors(model)
    if (factors is not None and len(factors) == 3
            and _is_spectral(factors[1])
            and isinstance(factors[2], GaussianLikelihood)):
        return SpectralVAMPSolver(model, damping=damping, tol=tol,
                                  max_iter=max_iter, **kw)
    if factors is not None:
        return MLVAMPSolver(model, damping=damping, tol=tol,
                            max_iter=max_iter, **kw)
    return EPSolver(model, damping=0.1 if damping is None else damping,
                    tol=tol, max_iter=max_iter, **kw)
