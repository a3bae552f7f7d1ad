"""Minimal insertion-ordered DAG container. Counterpart of
tramp_tpu/models/graph.py. Nodes are arbitrary objects hashed by identity;
edge order is preserved, which fixes the message-slot layout."""


class DiGraph:
    def __init__(self):
        self._succ = {}   # node -> list of successors
        self._pred = {}   # node -> list of predecessors

    def add_node(self, n):
        if n not in self._succ:
            self._succ[n] = []
            self._pred[n] = []

    def add_edge(self, u, v):
        self.add_node(u)
        self.add_node(v)
        if v not in self._succ[u]:
            self._succ[u].append(v)
            self._pred[v].append(u)

    def remove_node(self, n):
        for v in self._succ.pop(n, []):
            self._pred[v].remove(n)
        for u in self._pred.pop(n, []):
            self._succ[u].remove(n)

    @property
    def nodes(self):
        return list(self._succ.keys())

    @property
    def edges(self):
        return [(u, v) for u in self._succ for v in self._succ[u]]

    def successors(self, n):
        return list(self._succ[n])

    def predecessors(self, n):
        return list(self._pred[n])

    def in_degree(self, n):
        return len(self._pred[n])

    def out_degree(self, n):
        return len(self._succ[n])

    def copy(self):
        "A new graph with the same nodes and edges, in the same order."
        g = DiGraph()
        for n in self._succ:
            g.add_node(n)
        for u, v in self.edges:
            g.add_edge(u, v)
        return g

    def topological_sort(self):
        indeg = {n: len(self._pred[n]) for n in self._succ}
        ready = [n for n in self._succ if indeg[n] == 0]
        order = []
        while ready:
            n = ready.pop(0)
            order.append(n)
            for v in self._succ[n]:
                indeg[v] -= 1
                if indeg[v] == 0:
                    ready.append(v)
        if len(order) != len(self._succ):
            raise ValueError("graph has a cycle")
        return order
