"""DAG algebra: ``@`` (sequential composition via placeholder surgery) and
``+`` (parallel union), FactorDAG -> ModelDAG variable insertion, and
``to_observed`` channel->likelihood surgery.
Counterpart of tramp_tpu/models/dag_algebra.py."""
from ..base import Variable, Factor
from ..variables import SISOVariable, SILeafVariable
from .graph import DiGraph


class PlaceHolder:
    def math(self):
        return r"$\emptyset$"

    def __repr__(self):
        return type(self).__name__


class RootPlaceHolder(PlaceHolder):
    n_prev = 0
    n_next = 1


class LeafPlaceHolder(PlaceHolder):
    n_prev = 1
    n_next = 0


def check_dag(dag):
    for node in dag.nodes:
        n_prev = dag.in_degree(node)
        n_next = dag.out_degree(node)
        if n_prev != node.n_prev:
            raise ValueError(
                f"node {node} has {n_prev} predecessors "
                f"but should have {node.n_prev}")
        if n_next != node.n_next:
            raise ValueError(
                f"node {node} has {n_next} successors "
                f"but should have {node.n_next}")


def to_dag(node):
    "Wrap a single node with Root/Leaf placeholders. Reference l:81-88."
    dag = DiGraph()
    dag.add_node(node)
    for _ in range(node.n_next):
        dag.add_edge(node, LeafPlaceHolder())
    for _ in range(node.n_prev):
        dag.add_edge(RootPlaceHolder(), node)
    return dag


class DAG:
    def __init__(self, dag):
        if not isinstance(dag, DiGraph):
            dag = to_dag(dag)
        check_dag(dag)
        self.dag = dag
        nodes = dag.topological_sort()
        self._leafs_ph = [n for n in nodes if isinstance(n, LeafPlaceHolder)]
        self._roots_ph = [n for n in nodes if isinstance(n, RootPlaceHolder)]

    def __add__(self, other):
        if not isinstance(other, DAG):
            other = DAG(other)
        dag = DiGraph()
        for u, v in self.dag.edges:
            dag.add_edge(u, v)
        for u, v in other.dag.edges:
            dag.add_edge(u, v)
        return DAG(dag)

    def __matmul__(self, other):
        "Placeholder surgery: leafs of self wired to roots of other. Ref l:115-132."
        if not isinstance(other, DAG):
            other = DAG(other)
        dag = DiGraph()
        for u, v in self.dag.edges:
            dag.add_edge(u, v)
        for u, v in other.dag.edges:
            dag.add_edge(u, v)
        # zip semantics: extra leafs/roots remain as placeholders and can be
        # consumed by later compositions (reference l:121-131)
        for leaf, root in zip(self._leafs_ph, other._roots_ph):
            prevs = self.dag.predecessors(leaf)
            nexts = other.dag.successors(root)
            if len(prevs) != 1 or len(nexts) != 1:
                raise ValueError(f"cannot wire {leaf} to {root}")
            dag.remove_node(leaf)
            dag.remove_node(root)
            dag.add_edge(prevs[0], nexts[0])
        return DAG(dag)

    def to_factor_dag(self):
        return FactorDAG(self.dag)

    def to_model_dag(self):
        """A ModelDAG: the DAG itself when it names its variables, else its
        factors with variables inserted (FactorDAG.to_model_dag)."""
        for node in self.dag.nodes:
            if isinstance(node, Variable):
                return ModelDAG(self.dag)
        return FactorDAG(self.dag).to_model_dag()

    def to_model(self):
        "The lowered Model."
        from .base_model import Model
        return Model(self.to_model_dag())

    def plot(self, layout=None):
        from .dag_layout import plot_dag
        return plot_dag(self.dag, layout=layout)


def check_factor_dag(dag):
    for node in dag.nodes:
        if not isinstance(node, (Factor, PlaceHolder)):
            raise ValueError(f"node {node} must be a Factor or PlaceHolder")


class FactorDAG(DAG):
    "Factors-only DAG; variables are inserted. Reference l:184-212."

    def __init__(self, dag):
        if isinstance(dag, Variable):
            raise ValueError(f"Cannot convert variable {dag} to a FactorDAG")
        if isinstance(dag, Factor):
            dag = to_dag(dag)
        check_factor_dag(dag)
        super().__init__(dag)

    def to_model_dag(self):
        """Insert a SISO variable ``x_i`` on every factor->factor edge and a
        leaf ``y_j`` on every factor->placeholder edge, in edge order."""
        if self._roots_ph:
            raise ValueError(
                "cannot convert FactorDAG -> ModelDAG: "
                f"there are {len(self._roots_ph)} RootPlaceHolders")
        dag = DiGraph()
        id_x = id_y = 0
        for source, target in self.dag.edges:
            if isinstance(target, PlaceHolder):
                variable = SILeafVariable(id=f"y_{id_y}")
                id_y += 1
            else:
                variable = SISOVariable(id=f"x_{id_x}")
                id_x += 1
            dag.add_edge(source, variable)
            if not isinstance(target, PlaceHolder):
                dag.add_edge(variable, target)
        return ModelDAG(dag)


def check_model_dag(dag):
    for node in dag.nodes:
        if not isinstance(node, (Factor, Variable)):
            raise ValueError(f"node {node} should be a Factor or Variable")
        opposite = Factor if isinstance(node, Variable) else Variable
        for p in dag.predecessors(node):
            if not isinstance(p, opposite):
                raise ValueError(
                    f"predecessor {p} of {node} must be a {opposite}")
        for s in dag.successors(node):
            if not isinstance(s, opposite):
                raise ValueError(
                    f"successor {s} of {node} must be a {opposite}")


def channel2likelihood(channel, y, y_name):
    """Swap a leaf channel for the matching likelihood. Reference l:21-40.
    The likelihood takes ``y`` as it comes (a tensor keeps its device and
    dtype)."""
    from ..channels import (
        GaussianChannel, AbsChannel, AsymmetricAbsChannel, SgnChannel,
        ReluChannel, LeakyReluChannel, HardTanhChannel, HardSigmoidChannel,
        SymmetricDoorChannel, ModulusChannel,
    )
    from ..likelihoods import (
        GaussianLikelihood, AbsLikelihood, AsymmetricAbsLikelihood,
        SgnLikelihood, ReluLikelihood, LeakyReluLikelihood,
        HardTanhLikelihood, HardSigmoidLikelihood, SymmetricDoorLikelihood,
        ModulusLikelihood,
    )
    if isinstance(channel, GaussianChannel):
        return GaussianLikelihood(y=y, y_name=y_name, var=channel.var)
    if isinstance(channel, AsymmetricAbsChannel):
        return AsymmetricAbsLikelihood(y=y, y_name=y_name, shift=channel.shift)
    if isinstance(channel, AbsChannel):
        return AbsLikelihood(y=y, y_name=y_name)
    if isinstance(channel, SgnChannel):
        return SgnLikelihood(y=y, y_name=y_name)
    if isinstance(channel, LeakyReluChannel):
        return LeakyReluLikelihood(slope=channel.slope, y=y, y_name=y_name)
    if isinstance(channel, ReluChannel):
        return ReluLikelihood(y=y, y_name=y_name)
    if isinstance(channel, HardTanhChannel):
        return HardTanhLikelihood(y=y, y_name=y_name)
    if isinstance(channel, HardSigmoidChannel):
        return HardSigmoidLikelihood(y=y, y_name=y_name)
    if isinstance(channel, SymmetricDoorChannel):
        return SymmetricDoorLikelihood(y=y, y_name=y_name, width=channel.width)
    if isinstance(channel, ModulusChannel):
        return ModulusLikelihood(y=y, y_name=y_name)
    raise NotImplementedError(f"cannot convert {channel} to likelihood")


class ModelDAG(DAG):
    def __init__(self, dag):
        if isinstance(dag, (Variable, Factor)):
            dag = to_dag(dag)
        check_model_dag(dag)
        super().__init__(dag)

    def to_observed(self, observations):
        """New ModelDAG with observed leaf variables replaced by likelihoods.
        Reference dag_algebra.py:243-291."""
        observed_ids = set(observations.keys())

        def is_observed(node):
            return isinstance(node, Variable) and node.id in observed_ids

        def is_likelihood(node):
            if not isinstance(node, Factor):
                return False
            return any(v.id in observed_ids
                       for v in self.dag.successors(node))

        cache = {}

        def as_likelihood(node):
            if node not in cache:
                ids = [v.id for v in self.dag.successors(node)
                       if v.id in observed_ids]
                if len(ids) != 1:
                    raise ValueError(f"cannot convert {node} to likelihood")
                cache[node] = channel2likelihood(
                    node, y=observations[ids[0]], y_name=ids[0])
            return cache[node]

        dag = DiGraph()
        for source, target in self.dag.edges:
            if is_observed(target):
                if target.n_next != 0:
                    raise ValueError(f"{target} not a leaf")
                # drop the edge (y absorbed into the likelihood)
            elif is_likelihood(target):
                dag.add_edge(source, as_likelihood(target))
            else:
                dag.add_edge(source, target)
        return ModelDAG(dag)
