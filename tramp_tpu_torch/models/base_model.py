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


def to_list(X):
    "``X`` as a list: a tuple's items, anything else alone."
    if not isinstance(X, tuple):
        X = (X,)
    return list(X)


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
        self._second_moments = None

    def __repr__(self):
        return f"Model(n_factors={self.n_factors}, n_variables={self.n_variables})"

    # -- structural helpers ---------------------------------------------
    def variable_index(self, id):
        for i, n in enumerate(self.nodes):
            if isinstance(n, Variable) and n.id == id:
                return i
        raise ValueError(f"id={id} not in variables")

    def plot(self, layout=None):
        return self.model_dag.plot(layout)

    def to_observed(self, observations):
        return Model(self.model_dag.to_observed(observations))

    def device_dtype(self):
        """Device and (real) dtype of the factors' arrays, else those a factor was
        built with, else the config defaults (which need a card)."""
        for f in self.factors:
            for buf in f.buffers():
                # a complex operator's messages are its real parts, packed
                return buf.device, buf.dtype.to_real()
        for f in self.factors:
            if getattr(f, "device", None) is not None:
                return torch.device(f.device), f.dtype or DEFAULT_DTYPE
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
            X_next = _per_output(node, node.sample(generator, *X_prev))
            for X, e in zip(X_next, self.out_edges[i]):
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
        self._shapes = self._propagate(
            lambda node, prev: node.out_shape(*prev))
        return self._shapes

    def init_second_moments(self):
        """Propagate tau through the factors: {node index of a variable:
        its second moment}, each a Python number or a tensor (per lane when
        a hyperparameter is). Reference base_model.py:111-124."""
        self._second_moments = self._propagate(
            lambda node, prev: node.second_moment(*prev))
        return self._second_moments

    def _propagate(self, rule):
        """{node index of a variable: value} from ``rule(factor, values of
        its inputs)``, which gives one value per output of the factor (a
        list or tuple when it has several)."""
        values = {}
        for i, node in enumerate(self.nodes):
            if not isinstance(node, Factor) or node.n_next == 0:
                continue
            prev = [values[self.edges[e][0]] for e in self.in_edges[i]]
            for value, e in zip(_per_output(node, rule(node, prev)),
                                self.out_edges[i]):
                values[self.edges[e][1]] = value
        return values

    def get_shapes(self):
        shapes = self.init_shapes()
        return {n.id: shapes[i] for i, n in enumerate(self.nodes)
                if isinstance(n, Variable) and i in shapes}

    def get_second_moments(self):
        taus = self.init_second_moments()
        return {n.id: taus[i] for i, n in enumerate(self.nodes)
                if isinstance(n, Variable) and i in taus}


def _per_output(node, value):
    "A factor's result as a list with one entry per output."
    return list(value) if node.n_next > 1 else [value]


def _meta_factor(factor):
    """Shallow copy of ``factor`` with its buffers replaced by meta tensors;
    an operator split over a mesh's model axis keeps its ``model_shard``."""
    meta = copy.copy(factor)
    meta.__dict__["_buffers"] = {
        k: None if v is None else _meta_tensor(v)
        for k, v in factor._buffers.items()}
    return meta


def _meta_tensor(t):
    meta = torch.empty_like(t, device="meta")
    if getattr(t, "model_shard", None) is not None:
        meta.model_shard = t.model_shard
    return meta
