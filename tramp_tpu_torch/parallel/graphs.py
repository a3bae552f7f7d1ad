"""The capture of a solver loop's iteration as one CUDA graph, shared by the
plans of ``MLVAMPSolver`` (parallel/ml_vamp.py) and of the generic loop
(parallel/solver.py).

A plan runs its first iteration eagerly on a side stream (``warm``: the
handles, workspaces and caches a first call makes are made outside the
capture), then captures the next (``capture``), and each later iteration
replays the graph (``replay``). Capture launches nothing, so the host's
counters that count the launches and the quadrature nodes of an iteration
(``COUNTERS``) are set back after it and advanced by the captured amount on
every replay.
"""
import torch

from .. import trace
from ..ops import pl_fused
from ..utils import integration

#: (object, attribute) of every counter an iteration advances on the host:
#: the message kernels' launches and the quadrature's integrand evaluations
COUNTERS = ((pl_fused.pl_forward_message, "launches"),
            (pl_fused.pl_backward_message, "launches"),
            (pl_fused.pl_posterior, "launches"),
            (integration, "nodes_evaluated"))


def warm(iterate):
    "``iterate()`` eagerly on a side stream, which the current one awaits."
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        iterate()
    torch.cuda.current_stream().wait_stream(side)


def capture(iterate):
    """``iterate()`` captured as a CUDA graph: (graph, the counters'
    advances, ``[(object, attribute, n)]``), or (None, []) where the capture
    raised (an iteration that reads the device from the host)."""
    before = [getattr(o, a) for o, a in COUNTERS]
    graph = torch.cuda.CUDAGraph()
    # cuBLAS keeps a workspace per stream: the capture's is made in the
    # graph's own memory pool, and none outlives the capture in the memory
    # counted as allocated (the graph's stays in its pool; the current
    # stream makes its own again at its next product)
    _clear_cublas_workspaces()
    try:
        with torch.cuda.graph(graph):
            iterate()
    except RuntimeError:
        return None, []
    finally:
        _clear_cublas_workspaces()
        counted = [getattr(o, a) - n for (o, a), n in zip(COUNTERS, before)]
        for (o, a), n in zip(COUNTERS, before):
            setattr(o, a, n)
    return graph, [(o, a, n) for (o, a), n in zip(COUNTERS, counted) if n]


def replay(graph, counts):
    "One replay of ``graph`` (span ``replay``) and its counters advanced."
    with trace.span("replay"):
        graph.replay()
    for o, a, n in counts:
        setattr(o, a, getattr(o, a) + n)


def leaves(tree):
    """The tensors of nested dicts, lists and tuples, in order: a plan's
    buffers, or what a solve copies into them; a None branch has none."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [v for k in tree for v in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [v for branch in tree for v in leaves(branch)]
    return []


def _clear_cublas_workspaces():
    "Free cuBLAS's workspaces, one per stream; the next product makes one."
    torch.cuda.synchronize()
    torch._C._cuda_clearCublasWorkspaces()
