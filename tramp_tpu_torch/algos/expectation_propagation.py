"""Expectation Propagation engine. Counterpart of
tramp_tpu/algos/expectation_propagation.py."""
import math

import torch

from ..base import Variable, compute_ab_new
from ..channels import LinearChannel
from .message_passing import MessagePassing, slot, FWD, BWD


def _ab(msg):
    return msg["a"], msg["b"]


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

    # -- spectral-image carry ---------------------------------------------
    # Dense LinearChannels carry u = U^T bx across sweeps (the state's
    # trailing cache dict): the forward pass reads the image the previous
    # backward pass computed, since the forward pass writes only fwd slots
    # and bx (the bwd slot of the factor's out edge) cannot change in
    # between. This saves one thin (Nx, k) matvec per linear factor per
    # sweep; the math lives in LinearChannel.spectral_*_posterior, the same
    # code as the uncached path.
    def _init_spectral_factors(self):
        return [i for i, node in enumerate(self.nodes)
                if type(node) is LinearChannel]

    # -- factor ops -------------------------------------------------------
    # Every factor ported so far has at most one input and one output
    # variable (n_prev, n_next <= 1).
    def _factor_forward(self, i, node, state, aux=None):
        e_out = self.model.out_edges[i][0]
        ax, bx = _ab(state[slot(e_out, BWD)])
        if node.n_prev == 0:
            a_new, b_new = node.compute_forward_message(ax, bx)
        else:
            az, bz = _ab(state[slot(self.model.in_edges[i][0], FWD)])
            if i in self._spectral:
                # the carried u = U^T bx: no fresh U^T matvec
                u = state[self.n_slots][str(i)]
                rx, vx = node.spectral_forward_posterior(az, bz, ax, u)
                a_new, b_new = compute_ab_new(rx, vx, ax, bx)
            else:
                a_new, b_new = node.compute_forward_message(az, bz, ax, bx)
        return {slot(e_out, FWD): {"a": a_new, "b": b_new}}

    def _factor_backward(self, i, node, state, aux=None):
        e_in = self.model.in_edges[i][0]
        az, bz = _ab(state[slot(e_in, FWD)])
        if node.n_next == 0:
            a_new, b_new = node.compute_backward_message(az, bz)
            return {slot(e_in, BWD): {"a": a_new, "b": b_new}}
        ax, bx = _ab(state[slot(self.model.out_edges[i][0], BWD)])
        if i in self._spectral:
            # the fresh U^T bx becomes the carried image
            rz, vz, u = node.spectral_backward_posterior(az, bz, ax, bx)
            a_new, b_new = compute_ab_new(rz, vz, az, bz)
            return {slot(e_in, BWD): {"a": a_new, "b": b_new},
                    ("spec", str(i)): u}
        a_new, b_new = node.compute_backward_message(az, bz, ax, bx)
        return {slot(e_in, BWD): {"a": a_new, "b": b_new}}

    # -- posterior update (reference expectation_propagation.py:17-19) ----
    def update(self, variable, post):
        a_hat, b_hat = post["a"], post["b"]
        return dict(r=b_hat / a_hat, v=1.0 / a_hat)

    # -- objective ---------------------------------------------------------
    def variable_objective(self, var, v_idx, post):
        "Variable log partition. Reference base.py:146-150."
        ax, bx = post["a"], post["b"]
        logZ = 0.5 * torch.sum(
            bx**2 / ax + torch.log(2 * math.pi / ax) * torch.ones_like(bx))
        return torch.where(torch.all(ax > 0), logZ, math.inf)

    def node_objective_at(self, i, state):
        node = self.nodes[i]
        if isinstance(node, Variable):
            return self.variable_objective(node, i, self._posterior(i, state))
        if node.n_prev == 0:
            ax, bx = _ab(state[slot(self.model.out_edges[i][0], BWD)])
            return node.compute_log_partition(ax, bx)
        az, bz = _ab(state[slot(self.model.in_edges[i][0], FWD)])
        if node.n_next == 0:
            return node.compute_log_partition(az, bz, node.y)
        ax, bx = _ab(state[slot(self.model.out_edges[i][0], BWD)])
        return node.compute_log_partition(az, bz, ax, bx)

    def log_evidence(self, update=True):
        """The Bethe log evidence of one instance at the engine's state
        (reference expectation_propagation.py:169-175)."""
        if update:
            self.update_objective()
        return self.A_model

    def surprisal(self, update=True):
        return -self.log_evidence(update)
