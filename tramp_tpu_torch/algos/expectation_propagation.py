"""Expectation Propagation engine. Counterpart of
tramp_tpu/algos/expectation_propagation.py."""
import math

import torch

from .. import config
from ..base import Variable, compute_ab_new
from ..channels import LinearChannel
from .message_passing import MessagePassing, slot, FWD, BWD


def _unwrap(msgs, n):
    """(a, b) of the messages of a factor's n edges on one side: the
    message itself when n == 1, else lists in the model's edge order
    (reference expectation_propagation.py:9-15)."""
    a = [m["a"] for m in msgs]
    b = [m["b"] for m in msgs]
    if n == 1:
        return a[0], b[0]
    return a, b


class ExpectationPropagation(MessagePassing):

    # reference default EP callback EarlyStoppingEP (callbacks.py:250-286):
    # stop on relative-r change < tol; rollback + stop when the relative
    # change jumps above 0.2 after 5 iterations (catches the reset cycle
    # after perfect recovery, where precisions hit AMAX).
    default_stop_kind = "r"
    rollback_increase = 0.2
    wait_increase = 5

    def __init__(self, model):
        model.init_shapes()
        super().__init__(model, message_keys=["a", "b"])
        # dense linear factors whose bx slot is pinned: the image U^T bx is
        # a constant of the run (_pinned_image)
        self._pinned_linear = frozenset(
            i for i in self._dense_linear()
            if self._bx_slot(i) in self.pinned)

    def _dense_linear(self):
        return [i for i, node in enumerate(self.nodes)
                if type(node) is LinearChannel]

    def _bx_slot(self, i):
        "The slot of bx, the backward message into factor i's out edge."
        return slot(self.model.out_edges[i][0], BWD)

    def _prepare(self, model):
        """With pinned slots, the dict in which the first sweep of a run
        keeps their messages (``_pinned_slots``) and the images of pinned
        bx slots (``_pinned_image``); else None."""
        return {} if self.pinned else None

    # -- pinned constant messages (config.PIN_CONSTANT_MESSAGES) ------------
    # (tramp_tpu/algos/expectation_propagation.py:31-45): the Gaussian
    # likelihood's backward message and the Gaussian prior's forward one are
    # model constants.
    def _constant_factor_message(self, node):
        if node.n_next == 0:
            fn = getattr(node, "constant_backward_message", None)
            return fn is not None and fn() is not None
        if node.n_prev == 0:
            return getattr(node, "constant_forward_message", None) is not None
        return False

    def _factor_constant_message(self, model, i):
        node = model.nodes[i]
        if node.n_next == 0:
            return node.constant_backward_message()
        return node.constant_forward_message()

    def _pinned_image(self, i, node, state, aux):
        """U^T bx of a linear factor whose bx slot is pinned, computed at the
        run's first sweep from the pinned slot and kept in ``aux``."""
        images = aux.setdefault("images", {})
        if i not in images:
            msg = self._load_msg(state[self._bx_slot(i)])
            images[i] = node.spectral_image(msg["b"], msg["a"])
        return images[i]

    def _fill_aux(self, model, state, aux):
        """The pinned slots' messages and the images of pinned bx slots,
        as the first sweep from ``state`` computes them."""
        aux = super()._fill_aux(model, state, aux)
        if self._pinned_linear:
            swept = list(state)
            for s, msg in aux["pinned"].items():
                swept[s] = msg
            for i in self._pinned_linear:
                self._pinned_image(i, model.nodes[i], swept, aux)
        return aux

    # -- spectral-image carry (config.SPECTRAL_CARRY) ------------------------
    # Dense LinearChannels carry u = U^T bx across sweeps (the state's
    # trailing cache dict): the forward pass reads the image the previous
    # backward pass computed, since the forward pass writes only fwd slots
    # and bx (the bwd slot of the factor's out edge) cannot change in
    # between. This saves one thin (Nx, k) matvec per linear factor per
    # sweep; the math lives in LinearChannel.spectral_*_posterior, the same
    # code as the uncached path. A factor whose bx slot is pinned carries
    # nothing: its image is a constant of the run, so the state's layout
    # (and a checkpoint's ``spec_*`` keys) is the JAX package's.
    def _init_spectral_factors(self):
        if not config.spectral_carry():
            return ()
        return [i for i in self._dense_linear()
                if self._bx_slot(i) not in self.pinned]

    # -- factor ops -------------------------------------------------------
    # A factor reads the messages on its in edges (forward slots) and out
    # edges (backward slots) and writes one message per edge of the side it
    # updates: lists for a factor with several inputs or outputs. A spectral
    # factor is a LinearChannel, so it has one edge on each side.
    def _factor_forward(self, i, node, state, aux=None):
        prev_msgs, next_msgs = self._gather(i, state)
        ax, bx = _unwrap(next_msgs, node.n_next)
        if node.n_prev == 0:
            a_new, b_new = node.compute_forward_message(ax, bx)
        else:
            az, bz = _unwrap(prev_msgs, node.n_prev)
            if i in self._spectral or i in self._pinned_linear:
                # the carried u = U^T bx, or the run's image of a pinned
                # bx: no fresh U^T matvec
                u = (state[self.n_slots][str(i)] if i in self._spectral
                     else self._pinned_image(i, node, state, aux))
                rx, vx = node.spectral_forward_posterior(az, bz, ax, u)
                a_new, b_new = compute_ab_new(rx, vx, ax, bx)
            else:
                a_new, b_new = node.compute_forward_message(az, bz, ax, bx)
        out_edges = self.model.out_edges[i]
        if node.n_next == 1:
            return {slot(out_edges[0], FWD): {"a": a_new, "b": b_new}}
        return {slot(e, FWD): {"a": a, "b": b}
                for e, a, b in zip(out_edges, a_new, b_new)}

    def _factor_backward(self, i, node, state, aux=None):
        prev_msgs, next_msgs = self._gather(i, state)
        az, bz = _unwrap(prev_msgs, node.n_prev)
        in_edges = self.model.in_edges[i]
        if node.n_next == 0:
            a_new, b_new = node.compute_backward_message(az, bz)
        else:
            ax, bx = _unwrap(next_msgs, node.n_next)
            if i in self._spectral:
                # the fresh U^T bx becomes the carried image
                rz, vz, u = node.spectral_backward_posterior(az, bz, ax, bx)
                a_new, b_new = compute_ab_new(rz, vz, az, bz)
                return {slot(in_edges[0], BWD): {"a": a_new, "b": b_new},
                        ("spec", str(i)): u}
            if i in self._pinned_linear:
                rz, vz, _ = node.spectral_backward_posterior(
                    az, bz, ax, bx, self._pinned_image(i, node, state, aux))
                a_new, b_new = compute_ab_new(rz, vz, az, bz)
            else:
                a_new, b_new = node.compute_backward_message(az, bz, ax, bx)
        if node.n_prev == 1:
            return {slot(in_edges[0], BWD): {"a": a_new, "b": b_new}}
        return {slot(e, BWD): {"a": a, "b": b}
                for e, a, b in zip(in_edges, a_new, b_new)}

    # -- posterior update (reference expectation_propagation.py:17-19) ----
    def update(self, variable, post):
        a_hat, b_hat = post["a"], post["b"]
        return dict(r=b_hat / a_hat, v=1.0 / a_hat)

    # -- objective ---------------------------------------------------------
    def variable_objective(self, var, v_idx, post, aux=None):
        "Variable log partition. Reference base.py:146-150."
        ax, bx = post["a"], post["b"]
        logZ = 0.5 * torch.sum(
            bx**2 / ax + torch.log(2 * math.pi / ax) * torch.ones_like(bx))
        return torch.where(torch.all(ax > 0), logZ, math.inf)

    def node_objective_at(self, i, state, aux=None):
        "Reference expectation_propagation.py:154-171."
        node = self.nodes[i]
        if isinstance(node, Variable):
            return self.variable_objective(node, i, self._posterior(i, state))
        prev_msgs, next_msgs = self._gather(i, state)
        if node.n_prev == 0:
            ax, bx = _unwrap(next_msgs, node.n_next)
            return node.compute_log_partition(ax, bx)
        az, bz = _unwrap(prev_msgs, node.n_prev)
        if node.n_next == 0:
            return node.compute_log_partition(az, bz, node.y)
        ax, bx = _unwrap(next_msgs, node.n_next)
        return node.compute_log_partition(az, bz, ax, bx)

    def log_evidence(self, update=True):
        """The Bethe log evidence of one instance at the engine's state
        (reference expectation_propagation.py:169-175)."""
        if update:
            self.update_objective()
        return self.A_model

    def surprisal(self, update=True):
        return -self.log_evidence(update)
