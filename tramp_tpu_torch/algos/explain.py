"""Introspection engines: print every message per node per half-sweep, or
emit the schedule as LaTeX. Counterpart of tramp_tpu/algos/explain.py
(reference tramp/algos/explain_mp.py, explain_se.py and display_mp.py).

They print the lines of the JAX package for the same model. The sweep is
the engine's own; the explain engines keep the raw initial state (the
engine's shape sweeps would print) and carry no spectral image (its update
is not a message)."""
from ..base import Factor
from .expectation_propagation import ExpectationPropagation
from .state_evolution import StateEvolution
from .message_passing import slot, FWD, BWD
from .initial_conditions import ConstantInit


def _fmt_msg(msg, keys):
    parts = []
    for k in ("a",) + tuple(keys):
        if k in msg:
            val = msg[k]
            if val.ndim == 0:
                parts.append(f"{k}={float(val):.3f}")
            else:
                parts.append(f"{k}_shape={tuple(val.shape)}")
    return " ".join(parts)


class _ExplainMixin:
    """Wraps the per-node updates of the parent engine with prints."""

    harmonize = False

    def __init__(self, model, keys=(), print_incoming=True,
                 print_outcoming=True, **kwargs):
        super().__init__(model, **kwargs)
        self.keys = keys
        self.print_incoming = print_incoming
        self.print_outcoming = print_outcoming

    def _init_spectral_factors(self):
        return ()

    def _describe_in(self, i, state):
        node = self.nodes[i]
        print(f"{node}: incoming message")
        for e in self.model.in_edges[i]:
            src = self.nodes[self.edges[e][0]]
            print(f"  {src.id}->{node.id} "
                  f"{_fmt_msg(state[slot(e, FWD)], self.keys)}")
        for e in self.model.out_edges[i]:
            dst = self.nodes[self.edges[e][1]]
            print(f"  {node.id}<-{dst.id} "
                  f"{_fmt_msg(state[slot(e, BWD)], self.keys)}")

    def _describe_out(self, i, updates):
        node = self.nodes[i]
        print(f"{node}: outgoing message")
        for s, msg in updates.items():
            e, d = divmod(s, 2)
            other = self.nodes[self.edges[e][1] if self.edges[e][0] == i
                               else self.edges[e][0]]
            arrow = "->" if d == FWD else "<-"
            print(f"  {node.id}{arrow}{other.id} {_fmt_msg(msg, self.keys)}")

    def _factor_forward(self, i, node, state, aux):
        if self.print_incoming:
            self._describe_in(i, state)
        updates = super()._factor_forward(i, node, state, aux)
        if self.print_outcoming:
            self._describe_out(i, updates)
        return updates

    def _factor_backward(self, i, node, state, aux):
        if self.print_incoming:
            self._describe_in(i, state)
        updates = super()._factor_backward(i, node, state, aux)
        if self.print_outcoming:
            self._describe_out(i, updates)
        return updates

    def run(self, n_iter=1, initializer=None):
        initializer = initializer or ConstantInit(a=0, b=0)
        self.state = self.init_state(initializer)
        damp = self._damping_per_slot(None)
        aux = self._prepare(self.model)
        for _ in range(n_iter):
            print("FORWARD+BACKWARD PASS")
            print("-" * 21)
            self.state = self._sweep(self.model, self.state, damp, aux)
        return self

    def iterate(self, max_iter=1, initializer=None, **_ignored):
        "Sweeps that print what they compute."
        return self.run(n_iter=max_iter, initializer=initializer)


class ExplainMessagePassing(_ExplainMixin, ExpectationPropagation):
    pass


class ExplainStateEvolution(_ExplainMixin, StateEvolution):
    pass


def _math(node):
    try:
        return node.math()[1:-1]
    except Exception:
        return str(node)


class DisplayLatexMessagePassing(ExpectationPropagation):
    "Emit the message schedule as LaTeX lines. Reference display_mp.py:28-80."

    harmonize = False

    def _init_spectral_factors(self):
        return ()

    def iterate(self, max_iter=1, **_ignored):
        latex = self.run()
        for direction in ("forward", "backward"):
            for line in latex[direction]:
                print(line)
        return self

    def run(self):
        self.latex = dict(forward=[], backward=[])
        self.state = self.init_state(ConstantInit(a=0, b=0))
        for i, node in enumerate(self.nodes):
            if node.n_next == 0 and isinstance(node, Factor):
                continue
            ins = [_math(self.nodes[self.edges[e][0]])
                   for e in self.model.in_edges[i]]
            outs = [_math(self.nodes[self.edges[e][1]])
                    for e in self.model.out_edges[i]]
            m = (r"\mathrm{forward}\;" + ",".join(ins)
                 + r" \rightarrow " + _math(node)
                 + r" \rightarrow " + ",".join(outs))
            self.latex["forward"].append(rf"${m}$")
        for i in reversed(range(len(self.nodes))):
            node = self.nodes[i]
            if node.n_prev == 0:
                continue
            ins = [_math(self.nodes[self.edges[e][1]])
                   for e in self.model.out_edges[i]]
            outs = [_math(self.nodes[self.edges[e][0]])
                    for e in self.model.in_edges[i]]
            m = (r"\mathrm{backward}\;" + ",".join(ins)
                 + r" \rightarrow " + _math(node)
                 + r" \rightarrow " + ",".join(outs))
            self.latex["backward"].append(rf"${m}$")
        return self.latex
