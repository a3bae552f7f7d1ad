"""Model visualization: factor-graph rendering with pure matplotlib.
Counterpart of tramp_tpu/models/dag_layout.py (which replaces the
reference's daft dependency, tramp/models/dag_layout.py:5-75 and
dag_algebra.py:144-173). Layout: x = topological depth, y = branch offset
computed by a small sweep over the DAG. matplotlib is imported by the plot
only."""
import numpy as np


class Layout:
    def __init__(self, dx=1.0, dy=1.0):
        self.dx = dx
        self.dy = dy

    def compute(self, dag):
        "Assign (x, y) to every node: x = depth, y = leaf-count offsets."
        order = dag.topological_sort()
        depth = {}
        for n in order:
            preds = dag.predecessors(n)
            depth[n] = 0 if not preds else max(depth[p] for p in preds) + 1
        # y: distribute leaves of the 'branch tree' evenly
        y = {}
        next_y = [0.0]

        def assign_y(n):
            if n in y:
                return y[n]
            succs = dag.successors(n)
            if not succs:
                y[n] = next_y[0]
                next_y[0] += self.dy
            else:
                y[n] = float(np.mean([assign_y(s) for s in succs]))
            return y[n]

        for n in order:
            assign_y(n)
        pos = {n: (depth[n] * self.dx, y[n]) for n in order}
        return pos


def plot_dag(dag, layout=None, ax=None):
    "Render the factor graph: circles = variables, squares = factors."
    import matplotlib.pyplot as plt
    import matplotlib.patches as mpatches
    from ..base import Variable, Factor

    layout = layout or Layout()
    pos = layout.compute(dag)
    if ax is None:
        _, ax = plt.subplots(figsize=(
            2 + max(p[0] for p in pos.values()),
            1.5 + max(p[1] for p in pos.values())))
    for u, v in dag.edges:
        (x0, y0), (x1, y1) = pos[u], pos[v]
        ax.annotate("", xy=(x1, y1), xytext=(x0, y0),
                    arrowprops=dict(arrowstyle="-|>", color="0.3"))
    for n, (x, y) in pos.items():
        label = getattr(n, "id", None) or type(n).__name__
        if isinstance(n, Variable):
            patch = mpatches.Circle((x, y), 0.16, fill=False, ec="k")
        elif isinstance(n, Factor):
            patch = mpatches.Rectangle((x - 0.14, y - 0.14), 0.28, 0.28,
                                       fc="0.85", ec="k")
        else:
            patch = mpatches.Circle((x, y), 0.1, fill=False, ec="0.6",
                                    ls=":")
        ax.add_patch(patch)
        ax.annotate(str(label), (x, y - 0.3), ha="center", fontsize=8)
    ax.set_xlim(-0.5, max(p[0] for p in pos.values()) + 0.5)
    ax.set_ylim(-0.6, max(p[1] for p in pos.values()) + 0.5)
    ax.set_aspect("equal")
    ax.axis("off")
    return ax
