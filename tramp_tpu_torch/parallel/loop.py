"""The solver loop of the port's batched solvers (``SpectralVAMPSolver``,
``MLVAMPSolver``, ``EPSolver`` and ``SESolver``), and its replay as a
captured CUDA graph.

The JAX package compiles a ``while_loop`` and batches it with ``vmap``. Here
the loop is a Python loop (``SolverLoop._run``) with one host read per
iteration (``mesh.all_done``), and a batch is a lane axis written out
(tramp_tpu_torch/lanes.py). An iteration (the solver's ``_iterate``)
updates the loop's state in place on the device, with no host read: the
solver's step, its finite test and its stop metric, then the frozen lanes
and the flags (``lanes.advance``). The flags are one per lane: ``n_iter``, ``conv``
(the stop criterion fired) and ``done``, and ``count``, the iterations run,
on the device. A lane that is done is frozen while the slower lanes go on,
as ``vmap`` freezes a lane whose ``cond`` is false, so a lane of a batched
solve follows the single solve on that lane's data.

A run opens the span ``solve``, a ``sweep`` per iteration and ``readout``
(``trace``). A solver gives the loop its own parts: ``_prepare`` (the lane
count, the device, the loop invariants and the carry of a run),
``_start`` (the loop state: ``carry``, ``metric`` and ``flags``),
``_iterate``, ``_readout``; a solver that keeps plans also ``_copied`` and
``_numbers`` (below) and ``_metric``, its stop metric of a carry.

On the card, off a mesh, the iteration is captured as one CUDA graph
(``Plan``), and each iteration replays it: one launch where the eager
iteration makes hundreds. A plan holds the loop's static buffers: the loop
state, the invariants, and a twin of the model whose tensors a solve
changes (``_copied``: every buffer and per-lane hyperparameter for the
generic loop, the terminal factor's tensors for ML-VAMP) are buffers of the
plan; each solve copies its own in (``Plan.load``). A replay runs the eager
iteration's kernels on the same arguments in the same order, so the answers
are the same bits. Plans live on the solver's class, one per lane count, so
that a front door which makes a new solver for every call
(``parallel.build_se_grid``) still captures once; a plan is replaced where
what its graph reads beyond those copies differs (``signature``).

A plan runs its first iteration eagerly on a side stream (the handles,
workspaces and caches a first call makes are made outside the capture),
then captures the next, and each later iteration replays the graph; the
spans ``capture`` and ``replay`` mark them. Capture launches nothing, so the
host's counters that count an iteration's launches and quadrature nodes
(``COUNTERS``) are set back after it and advanced by the captured amount on
every replay. A capture that raises (a factor whose message reads the
device from the host) leaves the plan failed: that solve finishes eagerly
on its buffers, which are then released, and later solves of its signature
run eagerly. A model on the CPU or on a mesh runs the same iteration
eagerly (``why_eager``).
"""
import numpy as np
import torch

from .. import config, trace
from ..lanes import hyperparameters, with_buffers
from ..ops import gb_prior, ml_vamp_finish, pl_fused
from ..utils import integration
from .mesh import all_done, map_tree, stop_groups

#: (object, attribute) of every counter an iteration advances on the host:
#: the kernels' launches and the quadrature's integrand evaluations
COUNTERS = ((pl_fused.pl_forward_message, "launches"),
            (pl_fused.pl_backward_message, "launches"),
            (pl_fused.pl_posterior, "launches"),
            (integration, "nodes_evaluated"),
            (gb_prior.gb_posterior, "launches"),
            (gb_prior.gb_message, "launches"),
            (ml_vamp_finish.ml_vamp_finish, "launches"))


def start_flags(B, device):
    "The flags of a loop before its first iteration, all zero."
    lanes = () if B is None else (B,)
    return {"n_iter": torch.zeros(lanes, dtype=torch.int64, device=device),
            "conv": torch.zeros(lanes, dtype=torch.bool, device=device),
            "done": torch.zeros(lanes, dtype=torch.bool, device=device),
            "count": torch.zeros((), dtype=torch.int64, device=device)}


def why_eager(model, device, groups):
    """Why a solve of ``model`` on ``device`` runs its loop eagerly, or None
    where it can replay a plan's graph: on a mesh (``groups``, or a model
    from ``shard_batched_model``) the stop flag is reduced over ranks, and
    off the card there is no graph."""
    if groups or getattr(model, "mesh_lanes", None) is not None:
        return "the model is on a mesh"
    if device.type != "cuda":
        return "the loop is not on a CUDA device"
    return None


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


def tensor_fields(model, indices):
    """(index, name) of the buffers and per-lane hyperparameters of the
    factors ``indices`` of ``model``: what a plan may copy in."""
    return [(i, name) for i in indices
            for name in (list(model.factors[i]._buffers)
                         + hyperparameters(model.factors[i]))
            if isinstance(getattr(model.factors[i], name, None),
                          torch.Tensor)]


def signature(solver, model, inputs, carry, B, tol):
    """What a captured graph reads beyond what ``Plan.load`` copies in: the
    solver's class, the lane count, tol, the solver's numbers and the
    switches a step reads, the model's structure and every factor's fields
    (a tensor the solver copies in by its layout, another tensor by its
    layout and storage, an array by its bytes, anything else as it is), a
    tensor a factor holds beside its fields by its storage, and the layouts
    of the invariants and the carry."""
    copied = set(solver._copied(model))
    out = [type(solver), B, tol, solver._numbers(), config.matvec_bf16(),
           config.VMIN, config.AMIN, config.AMAX,
           torch.backends.cuda.matmul.allow_tf32,
           [type(n) for n in model.nodes], model.edges]
    for i, f in enumerate(model.factors):
        out.append(type(f))
        for name in type(f)._data_fields + type(f)._meta_fields:
            out.append((name, _value(getattr(f, name, None),
                                     (i, name) in copied)))
        out += [(name, _value(v, False)) for name, v in vars(f).items()
                if isinstance(v, torch.Tensor) and (i, name) not in copied]
    out += [_layout(v) for v in leaves((inputs, carry))]
    return out


class SolverLoop:
    """The solver loop, which the batched solvers extend (module
    docstring). ``_plans``: the plans of the class by lane count, each
    class its own; a class that sets it None, and its subclasses, run
    eagerly everywhere."""

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        inherited = getattr(cls, "_plans", {})
        if "_plans" not in vars(cls) and inherited is not None:
            cls._plans = {}

    def _run(self, model, carry=None, stop=None, tol=None, own=False):
        """The loop from ``carry`` (None: the solver's own start); ``stop``:
        the process groups its stop flag is reduced over (None: those of the
        model's mesh, if any); ``tol``: None for the solver's own. Returns
        (post, carry, n_iter, conv); the carry is the plan's own on the
        graph path (the next solve of as many lanes overwrites it) unless
        ``own``."""
        with trace.span("solve"):
            tol = self.tol if tol is None else tol
            groups = stop_groups(model) if stop is None else stop
            B, device, inputs, carry = self._prepare(model, carry)
            plan = (None if self._plans is None
                    or why_eager(model, device, groups)
                    else self._plan(model, inputs, carry, B, tol))
            if plan is None:
                loop = self._start(model, inputs, B, carry)

                def iterate():
                    self._iterate(model, inputs, B, loop, tol)
            else:
                loop = plan.load(self, model, inputs, carry)

                def iterate():
                    plan.step(self)
            for _ in range(self.max_iter):
                with trace.span("sweep"):
                    iterate()
                # the one host read of the iteration
                if all_done(loop["flags"]["done"], groups):
                    break
            carry, flags = loop["carry"], loop["flags"]
            with trace.span("readout"):
                post = self._readout(model, carry, inputs, B)
            n_iter, conv = flags["n_iter"], flags["conv"]
            if plan is not None:
                if plan.failed:
                    # later solves of this signature run eagerly
                    plan.release()
                n_iter, conv = n_iter.clone(), conv.clone()
                if own:
                    carry = map_tree(torch.clone, carry)
            return post, carry, n_iter, conv

    def _plan(self, model, inputs, carry, B, tol):
        """The ``Plan`` of ``B`` lanes, kept on the solver's class: made at
        the first solve that can replay one, and again where the signature
        differs; None where the capture of this signature has raised."""
        sig = signature(self, model, inputs, carry, B, tol)
        plans = type(self)._plans
        plan = plans.get(B)
        if plan is None or plan.signature != sig:
            # the old plan's buffers and graph go before the new ones
            plans.pop(B, None)
            del plan
            plan = plans[B] = Plan(self, model, inputs, carry, B, tol, sig)
        return None if plan.failed else plan


class Plan:
    """The loop's static buffers for one lane count, and the solver's
    ``_iterate`` on them captured as one CUDA graph (module docstring): the
    loop state (``_start``), the invariants, and a twin of the model whose
    copied tensors (``_copied``) are buffers of the plan."""

    def __init__(self, solver, model, inputs, carry, B, tol, signature):
        self.signature = signature
        self.graph = None
        self.failed = False
        self.counts = []
        self.B, self.tol = B, tol
        self.copied = solver._copied(model)
        self.model = with_buffers(model, {
            (i, name): getattr(model.factors[i], name).clone()
            for i, name in self.copied})
        self.inputs = map_tree(torch.clone, inputs)
        self.loop = solver._start(self.model, self.inputs, B, carry)

    def load(self, solver, model, inputs, carry):
        """Copy a solve's inputs in: the copied tensors of ``model``, the
        invariants and ``carry`` (None: zeros, the zero carry); the stop
        metric from them, and the flags zeroed. Returns the loop state, the
        plan's own."""
        for i, name in self.copied:
            getattr(self.model.factors[i], name).copy_(
                getattr(model.factors[i], name))
        _copy_(self.inputs, inputs)
        own = self.loop["carry"]
        if carry is None:
            torch._foreach_zero_(leaves(own))
        else:
            _copy_(own, carry)
        _copy_(self.loop["metric"], solver._metric(own, self.inputs))
        torch._foreach_zero_(list(self.loop["flags"].values()))
        return self.loop

    def step(self, solver):
        """One iteration: a replay of the graph, its counters advanced;
        before the graph, the capture; after a capture that failed, the
        eager iteration."""
        if self.graph is not None:
            with trace.span("replay"):
                self.graph.replay()
            for o, a, n in self.counts:
                setattr(o, a, getattr(o, a) + n)
        elif self.failed:
            self._iterate(solver)
        else:
            with trace.span("capture"):
                self._capture(solver)

    def _iterate(self, solver):
        solver._iterate(self.model, self.inputs, self.B, self.loop, self.tol)

    def _capture(self, solver):
        "This iteration eagerly on a side stream, then the capture."
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            self._iterate(solver)
        torch.cuda.current_stream().wait_stream(side)
        before = [getattr(o, a) for o, a in COUNTERS]
        graph = torch.cuda.CUDAGraph()
        # cuBLAS keeps a workspace per stream: the capture's is made in the
        # graph's own memory pool, and none outlives the capture in the
        # memory counted as allocated (the graph's stays in its pool; the
        # current stream makes its own again at its next product)
        _clear_cublas_workspaces()
        try:
            with torch.cuda.graph(graph):
                self._iterate(solver)
        except RuntimeError:
            graph = None
        finally:
            _clear_cublas_workspaces()
            counted = [getattr(o, a) - n for (o, a), n in zip(COUNTERS,
                                                              before)]
            for (o, a), n in zip(COUNTERS, before):
                setattr(o, a, n)
        self.graph, self.failed = graph, graph is None
        if graph is not None:
            self.counts = [(o, a, n) for (o, a), n in zip(COUNTERS, counted)
                           if n]

    def release(self):
        "Drop the buffers and the graph; the signature stays, as failed."
        self.model = self.inputs = self.loop = self.graph = None


def _copy_(mine, theirs):
    "The tensors of ``theirs`` copied into ``mine``, a tree of its shape."
    if isinstance(mine, torch.Tensor):
        mine.copy_(theirs)
    elif isinstance(mine, dict):
        for k in mine:
            _copy_(mine[k], theirs[k])
    elif isinstance(mine, (list, tuple)):
        for m, t in zip(mine, theirs):
            _copy_(m, t)


def _clear_cublas_workspaces():
    "Free cuBLAS's workspaces, one per stream; the next product makes one."
    torch.cuda.synchronize()
    torch._C._cuda_clearCublasWorkspaces()


def _layout(t):
    "A tensor's shape, strides, dtype and device."
    return (tuple(t.shape), t.stride(), t.dtype, t.device)


def _value(v, copied):
    """A field as a signature compares it: a tensor a plan copies in by its
    layout, another tensor by its layout and storage, an array by its
    bytes, anything else as it is."""
    if isinstance(v, torch.Tensor):
        return _layout(v) if copied else (_layout(v), v.data_ptr())
    if isinstance(v, np.ndarray):
        return (v.shape, v.dtype.str, v.tobytes())
    return v
