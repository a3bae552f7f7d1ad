"""Model: a lowered, schedule-ready view of a ModelDAG.
Counterpart of tramp_tpu/models/base_model.py:26-119.

The DAG is flattened once into ``nodes`` (topological order), ``edges``
((u_idx, v_idx) pairs, which fix the message-slot layout) and per-node
in/out edge index lists, which the engines' sweeps walk."""
import copy

import torch

from ..base import Variable, Factor
from ..config import default_device, DEFAULT_DTYPE
from .dag_algebra import ModelDAG


class Model:
    def __init__(self, model_dag):
        if not isinstance(model_dag, ModelDAG):
            raise TypeError(f"model_dag {model_dag} is not a ModelDAG")
        self.model_dag = model_dag
        dag = model_dag.dag
        self.nodes = dag.topological_sort()
        index = {n: i for i, n in enumerate(self.nodes)}
        self.edges = [(index[u], index[v]) for u, v in dag.edges]
        # per-node ordered edge indices (order = successor/predecessor order,
        # which matches the reference's message parsing order)
        self.in_edges = [[] for _ in self.nodes]
        self.out_edges = [[] for _ in self.nodes]
        for e, (ui, vi) in enumerate(self.edges):
            self.out_edges[ui].append(e)
            self.in_edges[vi].append(e)

        self.variables = [n for n in self.nodes if isinstance(n, Variable)]
        self.variable_ids = [v.id for v in self.variables]
        if len(set(self.variable_ids)) != len(self.variable_ids):
            raise ValueError("duplicate variable ids")
        for v in self.variables:
            if v.id is None:
                raise ValueError(f"missing id for {v}")
        self.factors = [n for n in self.nodes if isinstance(n, Factor)]
        for idx, f in enumerate(self.factors):
            f.id = f"f_{idx}"
        self.n_variables = len(self.variables)
        self.n_factors = len(self.factors)
        self._shapes = None

    def __repr__(self):
        return f"Model(n_factors={self.n_factors}, n_variables={self.n_variables})"

    # -- structural helpers ---------------------------------------------
    def variable_index(self, id):
        for i, n in enumerate(self.nodes):
            if isinstance(n, Variable) and n.id == id:
                return i
        raise ValueError(f"id={id} not in variables")

    def to_observed(self, observations):
        return Model(self.model_dag.to_observed(observations))

    def device_dtype(self):
        "Device and dtype of the factors' arrays (the config defaults if none)."
        for f in self.factors:
            for buf in f.buffers():
                return buf.device, buf.dtype
        return default_device(), DEFAULT_DTYPE

    def to_meta(self):
        """A structural copy whose factors hold meta tensors in place of
        their arrays: running a sweep on it yields every message's shape and
        dtype without computing (the engine's shape sweep)."""
        model = object.__new__(Model)
        model.__dict__.update(self.__dict__)
        model.nodes = [_meta_factor(n) if isinstance(n, Factor) else n
                       for n in self.nodes]
        model.factors = [n for n in model.nodes if isinstance(n, Factor)]
        return model

    # -- sampling and shapes --------------------------------------------
    def sample(self, generator=None):
        """Ancestral sampling with one ``torch.Generator`` (None: torch's
        default generator). Reference base_model.py:71-94."""
        values = {}
        for i, node in enumerate(self.nodes):
            if not isinstance(node, Factor):
                continue
            X_prev = [values[self.edges[e][0]] for e in self.in_edges[i]]
            X = node.sample(generator, *X_prev)
            for e in self.out_edges[i]:
                values[self.edges[e][1]] = X
        return {
            n.id: values[i]
            for i, n in enumerate(self.nodes)
            if isinstance(n, Variable) and i in values
        }

    def init_shapes(self):
        """Variable shapes from each factor's ``out_shape`` rule (the JAX
        package evaluates ``sample`` abstractly, base_model.py:98-119)."""
        if self._shapes is not None:
            return self._shapes
        shapes = {}
        for i, node in enumerate(self.nodes):
            if not isinstance(node, Factor) or node.n_next == 0:
                continue
            prev_shapes = [shapes[self.edges[e][0]] for e in self.in_edges[i]]
            out = node.out_shape(*prev_shapes)
            for e in self.out_edges[i]:
                shapes[self.edges[e][1]] = out
        self._shapes = shapes
        return shapes


def _meta_factor(factor):
    "Shallow copy of ``factor`` with its buffers replaced by meta tensors."
    meta = copy.copy(factor)
    meta.__dict__["_buffers"] = {
        k: None if v is None else torch.empty_like(v, device="meta")
        for k, v in factor._buffers.items()}
    return meta
