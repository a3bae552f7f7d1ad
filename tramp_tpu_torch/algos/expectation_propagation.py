"""Expectation Propagation engine. Counterpart of
tramp_tpu/algos/expectation_propagation.py:17-144."""
from ..base import compute_ab_new
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
    def _factor_forward(self, i, node, state):
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

    def _factor_backward(self, i, node, state):
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
