"""Checkpoint / resume for batched solves. Counterpart of
tramp_tpu/parallel/checkpoint.py, whose orbax checkpointer is JAX's: here a
checkpoint is a directory holding one ``.npz``, the solver state flattened
with stable keys (``state.<index or key>...``) beside the per-lane
``n_iter``.

Typical use:

    solver = EPSolver(model, max_iter=200)
    post, state, n_iter = solver.solve_batch_with_state(stacked)
    save_checkpoint(path, state, n_iter)
    ...
    state, n_iter = restore_checkpoint(path, like=(state, n_iter))
    post, n_iter = solver.solve_batch(stacked, state=state)   # resumes

A state is any nesting of tuples, lists and dicts (string keys) of tensors:
an ``EPSolver``'s message state or an ``MLVAMPSolver``'s carry.

Over a device mesh both calls are collective, as orbax's are in the JAX
package: every rank calls them. The file holds the whole batch, whatever
the mesh that wrote it, so a checkpoint written by 4 ranks restores under 2,
under 1, or in one process without a mesh:

    template = shard_batched_state(state, mesh)      # this mesh's lanes
    state, n_iter = restore_checkpoint(path, like=(template, n_iter))"""
import os

import numpy as np
import torch
import torch.distributed as dist

FILE = "checkpoint.npz"


def _flatten(tree, key, out):
    "{dotted key: tensor} of the leaves of ``tree``."
    if isinstance(tree, torch.Tensor):
        out[key] = tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, f"{key}.{k}", out)
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            _flatten(v, f"{key}.{i}", out)
    else:
        raise TypeError(f"checkpoint leaf {key} is a {type(tree).__name__}, "
                        "not a tensor")
    return out


def _restore(like, key, data):
    """``like``'s structure with each leaf read from ``data``, placed like
    it; a leaf of a sharded template (``shard_batched_state``) gets this
    rank's lanes."""
    if isinstance(like, torch.Tensor):
        out = torch.as_tensor(data[key], dtype=like.dtype, device=like.device)
        where = getattr(like, "mesh_lanes", None)
        return out if where is None else where.part(out)
    if isinstance(like, dict):
        return {k: _restore(v, f"{key}.{k}", data) for k, v in like.items()}
    return type(like)(_restore(v, f"{key}.{i}", data)
                      for i, v in enumerate(like))


def _whole(t):
    "The whole batch of a tensor of a sharded state (every rank calls)."
    where = getattr(t, "mesh_lanes", None)
    return t if where is None else where.gather(t)


def save_checkpoint(path, state, n_iter):
    """Save a solver state and its iteration counters to ``path`` (a
    directory; created). Returns the path.

    In a process group every rank calls it: the tensors of a sharded state
    (``shard_batched_state``, ``restore_checkpoint`` with such a template)
    are gathered, rank 0 writes the whole batch, and a barrier follows; a
    state that every rank holds whole (a sharded solve's result) is written
    as it is."""
    path = str(path)
    flat = _flatten({"state": state, "n_iter": n_iter}, "", {})
    flat = {k: _whole(v) for k, v in flat.items()}
    rank = dist.get_rank() if dist.is_initialized() else 0
    if rank == 0:
        os.makedirs(path, exist_ok=True)
        arrays = {k[1:]: v.detach().cpu().numpy() for k, v in flat.items()}
        tmp = os.path.join(path, FILE + ".part")
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, os.path.join(path, FILE))
    if dist.is_initialized():
        dist.barrier()
    return path


def restore_checkpoint(path, like):
    """Restore a checkpoint written by :func:`save_checkpoint`.

    ``like`` is a ``(state, n_iter)`` template, such as the state a solve
    returns: every tensor is placed on the device and dtype of its
    counterpart there. A template sharded on a mesh
    (``shard_batched_state``, any mesh, whatever the one that wrote the
    checkpoint) gives each rank its own lanes. Returns ``(state,
    n_iter)``."""
    state_like, n_iter_like = like
    with np.load(os.path.join(str(path), FILE)) as data:
        data = {"." + k: data[k] for k in data.files}
    template = _flatten({"state": state_like, "n_iter": n_iter_like}, "", {})
    if set(data) != set(template) or any(
            data[k].shape[1:] != tuple(t.shape[1:])
            for k, t in template.items()):
        raise ValueError(f"checkpoint {path} does not hold the template's "
                         "structure")
    return (_restore(state_like, ".state", data),
            _restore(n_iter_like, ".n_iter", data))
