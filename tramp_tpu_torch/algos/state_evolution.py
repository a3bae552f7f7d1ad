"""State evolution engine: scalar-precision messages, ensemble-averaged
errors. Counterpart of tramp_tpu/algos/state_evolution.py.

The whole SE state is one precision per directed edge: a 0-d tensor, or
``(B, 1)`` with lanes (tramp_tpu_torch/lanes.py), so thousands of
(alpha, rho) grid points are one batched state swept by the same code
(``parallel.SESolver``). The state is float64 unless the caller asks for
another dtype: SE fixed points are compared in their last digits (golden
values, bisection decisions), and its arithmetic is a handful of scalars
and quadrature sums."""
import math

import torch

from ..base import Variable
from ..config import default_device
from .message_passing import MessagePassing, slot, FWD, BWD


def _unwrap_a(msgs, n):
    """The precisions of a factor's n edges on one side: the precision
    itself when n == 1, else a list in the model's edge order (reference
    state_evolution.py:12-14)."""
    a = [m["a"] for m in msgs]
    return a[0] if n == 1 else a


class StateEvolution(MessagePassing):
    """``StateEvolution(model).iterate(...)``; ``device`` is that of the
    model's arrays, else the one its factors were built with, else the first
    card (``device="cpu"`` runs on the CPU); ``dtype`` defaults to
    float64."""

    # reference default SE callback: EarlyStopping(max_increase=0.2,
    # wait_increase=5) with rollback (callbacks.py:195-243)
    default_stop_kind = "v"
    rollback_increase = 0.2
    wait_increase = 5

    needs_shapes = False

    def __init__(self, model, device=None, dtype=None):
        super().__init__(model, message_keys=["a"])
        if device is None:
            for f in model.factors:
                found = next((b.device for b in f.buffers()),
                             getattr(f, "device", None))
                if found is not None:
                    device = found
                    break
        self.device = torch.device(device) if device is not None \
            else default_device()
        self.dtype = dtype or torch.float64

    def device_dtype(self):
        return self.device, self.dtype

    def _lanes(self, state):
        a = state[0]["a"]
        return a.shape[0] if a.ndim else None

    def _prepare(self, model):
        "tau per variable node index, as tensors of the state's kind."
        return {i: torch.as_tensor(tau, device=self.device, dtype=self.dtype)
                for i, tau in model.init_second_moments().items()}

    def _tau_prev(self, i, aux):
        "Second moments of factor i's inputs: one, or a list of them."
        taus = [aux[self.model.edges[e][0]] for e in self.model.in_edges[i]]
        return taus[0] if self.model.nodes[i].n_prev == 1 else taus

    def _factor_forward(self, i, node, state, aux):
        prev_msgs, next_msgs = self._gather(i, state)
        ax = _unwrap_a(next_msgs, node.n_next)
        if node.n_prev == 0:
            a_new = node.compute_forward_state_evolution(ax)
        else:
            az = _unwrap_a(prev_msgs, node.n_prev)
            a_new = node.compute_forward_state_evolution(
                az, ax, self._tau_prev(i, aux))
        out_edges = self.model.out_edges[i]
        if node.n_next == 1:
            return {slot(out_edges[0], FWD): {"a": a_new}}
        return {slot(e, FWD): {"a": a} for e, a in zip(out_edges, a_new)}

    def _factor_backward(self, i, node, state, aux):
        prev_msgs, next_msgs = self._gather(i, state)
        az = _unwrap_a(prev_msgs, node.n_prev)
        tau_z = self._tau_prev(i, aux)
        if node.n_next == 0:
            a_new = node.compute_backward_state_evolution(az, tau_z)
        else:
            ax = _unwrap_a(next_msgs, node.n_next)
            a_new = node.compute_backward_state_evolution(az, ax, tau_z)
        in_edges = self.model.in_edges[i]
        if node.n_prev == 1:
            return {slot(in_edges[0], BWD): {"a": a_new}}
        return {slot(e, BWD): {"a": a} for e, a in zip(in_edges, a_new)}

    # -- posterior update (reference state_evolution.py:17-19) ------------
    def update(self, variable, post):
        return dict(v=1.0 / post["a"])

    # -- objective ---------------------------------------------------------
    def variable_objective(self, var, v_idx, post, aux=None):
        """Variable free energy. Reference base.py:133-136. ``aux``: the
        second moments, when the caller has them (an adaptive sweep scores
        132 objectives)."""
        ax = post["a"]
        tau_x = (self._prepare(self.model) if aux is None else aux)[v_idx]
        I = 0.5 * torch.log(ax * tau_x)
        return (0.5 * ax * tau_x - I
                + 0.5 * torch.log(2 * math.pi * tau_x / math.e))

    def node_objective_at(self, i, state, aux=None):
        node = self.nodes[i]
        if isinstance(node, Variable):
            return self.variable_objective(node, i, self._posterior(i, state),
                                           aux)
        prev_msgs, next_msgs = self._gather(i, state)
        if node.n_prev == 0:
            return node.compute_free_energy(_unwrap_a(next_msgs, node.n_next))
        tau_z = self._tau_prev(i, self._prepare(self.model) if aux is None
                               else aux)
        az = _unwrap_a(prev_msgs, node.n_prev)
        if node.n_next == 0:
            return node.compute_free_energy(az, tau_z)
        ax = _unwrap_a(next_msgs, node.n_next)
        return node.compute_free_energy(az, ax, tau_z)

    def entropy(self, update=True):
        if update:
            self.update_objective()
        return -self.A_model
