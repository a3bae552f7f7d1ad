"""Device meshes over torch.distributed: instance (data) parallelism over
the lanes of a batch and model parallelism over the dense operators.
Counterpart of tramp_tpu/parallel/mesh.py.

One process per device: ``nccl`` on the card, ``gloo`` on the CPU. The
JAX package places a stacked model on its mesh and lets XLA insert the
collectives; here each process holds its part of the model and the
collectives are written out:

- over the ``data`` axis, each rank holds an equal block of the lanes (in
  the order of the axis); a solve runs one loop whose stop flag is reduced
  over the ranks (``stop_groups``, ``all_done``), and gathers the results,
  so that every rank holds the whole batch, as a JAX global array reads;
- over the ``model`` axis, the dense operators (a class's
  ``_model_split_fields``) are split on their last axis, and the products
  that every dense operator goes through (``LinearChannel._mm``,
  ``utils.misc.pair_matmul``) add a sum or a gather (``ModelShard``).
  Vectors stay whole on every rank.

Typical use, one process per card (``torchrun --nproc-per-node=P``)::

    mesh = make_mesh((P, 1))                  # ("data", "model")
    sharded = shard_batched_model(stack_models(models), mesh)
    post, n_iter = EPSolver(models[0]).solve_batch(sharded)   # whole batch
"""
import math
import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from .. import trace
from ..lanes import hyperparameters, model_lanes, with_buffers
from ..utils.misc import ModelShard


def make_mesh(shape=None, axis_names=("data", "model"), device=None):
    """A ``DeviceMesh`` over the processes of the world. ``shape`` defaults
    to (world size, 1); a shape whose product is not the world size raises.
    ``device`` is "cuda" (the default) or "cpu"; the process group must
    have the matching backend, ``nccl`` or ``gloo``. Where no process group
    exists, one is made with that backend: from the environment a launcher
    such as ``torchrun`` sets (``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``), else for a world of this one process. A mesh never
    quietly takes the CPU."""
    device_type = torch.device(device or "cuda").type
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to build a "
                           "mesh of gloo processes on the CPU")
    backend = "nccl" if device_type == "cuda" else "gloo"
    if not dist.is_initialized():
        if "WORLD_SIZE" in os.environ:
            dist.init_process_group(backend)
        else:
            dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                    world_size=1)
    if backend not in str(dist.get_backend()):
        raise ValueError(f"a {device_type} mesh needs a {backend} process "
                         f"group, not {dist.get_backend()}")
    n = dist.get_world_size()
    shape = (n, 1) if shape is None else tuple(shape)
    if math.prod(shape) != n:
        raise ValueError(f"mesh shape {shape} != {n} processes")
    if device_type == "cuda":
        torch.cuda.set_device(int(os.environ.get(
            "LOCAL_RANK", dist.get_rank() % torch.cuda.device_count())))
    return init_device_mesh(device_type, shape,
                            mesh_dim_names=tuple(axis_names))


def axis_size(mesh, name):
    "The size of ``mesh``'s axis ``name``; 1 where the mesh has none."
    names = mesh.mesh_dim_names or ()
    return mesh.shape[names.index(name)] if name in names else 1


def axis_index(mesh, name):
    "This rank's coordinate on ``mesh``'s axis ``name``; 0 where none."
    names = mesh.mesh_dim_names or ()
    return mesh.get_local_rank(name) if name in names else 0


class MeshLanes:
    """Where the lanes of a batch lie on a mesh: ``lanes`` in all, split
    over ``data_axis`` into equal blocks in the order of that axis (this
    rank holds block ``index``, ``width`` lanes); the dense operators are
    split over ``model_axis`` where it has more than one rank. A sharded
    model carries one (``model.mesh_lanes``), and so does each tensor of a
    sharded state (``tensor.mesh_lanes``)."""

    def __init__(self, mesh, lanes, data_axis="data", model_axis="model"):
        self.mesh, self.lanes = mesh, lanes
        self.data_axis, self.model_axis = data_axis, model_axis
        parts = axis_size(mesh, data_axis)
        if lanes % parts:
            raise ValueError(f"batch {lanes} not divisible by "
                             f"{data_axis}={parts}")
        self.width = lanes // parts
        self.index = axis_index(mesh, data_axis)

    def stop_groups(self, over_data=True):
        """The groups a loop's stop flag is reduced over: the data axis
        (one loop for the whole batch; without it each rank stops when its
        own lanes are done), and the model axis where the operators are
        split, whose ranks share the lanes and so must stop together."""
        groups = [self.mesh.get_group(self.data_axis)] if over_data else []
        if axis_size(self.mesh, self.model_axis) > 1:
            groups.append(self.mesh.get_group(self.model_axis))
        return groups

    def part(self, t):
        "This rank's lanes of a tensor of the whole batch, a copy."
        out = t[self.index * self.width:(self.index + 1) * self.width]
        out = out.clone()
        out.mesh_lanes = self
        return out

    def local(self, tree):
        """``tree`` (a state: tuples, lists and dicts of tensors) with this
        rank's lanes: a tensor of the whole batch is cut, one of this rank's
        lanes is kept."""
        def cut(t):
            if t.shape[0] == self.width:
                return t
            if t.shape[0] != self.lanes:
                raise ValueError(f"a state tensor of shape {tuple(t.shape)}"
                                 f": need {self.lanes} or {self.width} "
                                 "lanes")
            return self.part(t)
        return map_tree(cut, tree)

    def gather(self, tree):
        "``tree`` with every tensor's lanes gathered over the data axis."
        group = self.mesh.get_group(self.data_axis)
        size = axis_size(self.mesh, self.data_axis)

        def whole(t):
            parts = [torch.empty_like(t) for _ in range(size)]
            dist.all_gather(parts, t.contiguous(), group=group)
            return torch.cat(parts)
        return map_tree(whole, tree)

    def count(self, flags):
        "The number of true ``flags`` over the data axis, on every rank."
        n = flags.sum().to(torch.int64).reshape(1)
        dist.all_reduce(n, group=self.mesh.get_group(self.data_axis))
        return n.reshape(())


def map_tree(fn, tree):
    "``fn`` of every tensor of nested tuples, lists and dicts; None stays."
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    return type(tree)(map_tree(fn, v) for v in tree)


def stop_groups(model):
    "The groups a solve's stop flag is reduced over: none without a mesh."
    where = getattr(model, "mesh_lanes", None)
    return [] if where is None else where.stop_groups()


def all_done(done, groups):
    """``done.all()`` over this rank's lanes and those of the ``groups``:
    the loop's one host read, after one ``all_reduce(MIN)`` per group
    (the span ``stop_read``)."""
    with trace.span("stop_read"):
        if not groups:
            return bool(done.all())
        flag = done.all().to(torch.int32).reshape(1)
        for group in groups:
            dist.all_reduce(flag, op=dist.ReduceOp.MIN, group=group)
        return bool(flag)


def whole_batch(tree, model):
    """Results of a solve on ``model`` with every lane of the batch: those
    of a sharded model gathered over the data axis, else ``tree`` as is."""
    where = getattr(model, "mesh_lanes", None)
    return tree if where is None else where.gather(tree)


def shard_batched_model(stacked_model, mesh, data_axis="data",
                        model_axis="model"):
    """This rank's part of a model whose buffers carry lanes
    (``lanes.stack_models`` or ``with_buffers``): the lanes (the first axis
    ``lanes.model_lanes`` recognises, on buffers and on per-lane
    hyperparameters) are split over ``data_axis``; the dense operators of
    ``LinearChannel``, ``ComplexLinearChannel`` and ``UnitaryChannel``
    (``W``, ``U``, ``V``; a class's ``_model_split_fields``) are split over
    ``model_axis`` on their last axis where its size divides it, the JAX
    package's ``_leaf_spec`` rule. Every other leaf stays whole on each rank:
    the singular values, ``y``, the hyperparameters, and the operators of
    the convolutional, low-rank and other structured channels. That changes
    memory, never results. The batch must divide over the data axis.

    The returned model carries its mesh (``.mesh``, ``.mesh_lanes``), so a
    solver knows that it is sharded."""
    template = getattr(stacked_model, "unstacked", None)
    B = None if template is None else model_lanes(stacked_model, template)
    if B is None:
        raise ValueError("shard_batched_model: no buffer of the model has "
                         "lanes (stack the instances with lanes.stack_models "
                         "or lanes.with_buffers)")
    where = MeshLanes(mesh, B, data_axis, model_axis)
    P = axis_size(mesh, model_axis)
    shard = ModelShard(mesh.get_group(model_axis), P,
                       axis_index(mesh, model_axis)) if P > 1 else None
    replace = {}
    for i, (factor, ref) in enumerate(zip(stacked_model.factors,
                                          template.factors)):
        for name in hyperparameters(factor):
            value = getattr(factor, name)
            if isinstance(value, torch.Tensor) and value.ndim > 0:
                replace[i, name] = where.part(value)
        split = getattr(factor, "_model_split_fields", ())
        for name, buf in factor._buffers.items():
            if buf is None:
                continue
            local = buf
            if buf.ndim == ref._buffers[name].ndim + 1:
                local = where.part(buf)
            if shard is not None and name in split \
                    and local.shape[-1] % P == 0:
                local = shard.block(local, -1, local.shape[-1] // P).clone()
                local.model_shard = shard
            if local is not buf:
                replace[i, name] = local
    out = with_buffers(stacked_model, replace)
    out.mesh, out.mesh_lanes = mesh, where
    return out


def shard_batched_state(state, mesh, data_axis="data", model_axis="model"):
    """This rank's part of a state with lanes (an ``EPSolver``'s message
    state or an ``MLVAMPSolver``'s carry, with the whole batch): the lanes
    are split over ``data_axis``, and each tensor carries where its lanes
    lie (``tensor.mesh_lanes``), so that ``restore_checkpoint`` with it as
    template gives each rank its own lanes. Messages are vectors, whole on
    the model axis."""
    leaves = []
    map_tree(leaves.append, state)
    where = MeshLanes(mesh, leaves[0].shape[0], data_axis, model_axis)
    return map_tree(where.part, state)
