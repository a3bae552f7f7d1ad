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
an ``EPSolver``'s message state or an ``MLVAMPSolver``'s carry."""
import os

import numpy as np
import torch

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
    "``like``'s structure with each leaf read from ``data``, placed like it."
    if isinstance(like, torch.Tensor):
        return torch.as_tensor(data[key], dtype=like.dtype,
                               device=like.device)
    if isinstance(like, dict):
        return {k: _restore(v, f"{key}.{k}", data) for k, v in like.items()}
    return type(like)(_restore(v, f"{key}.{i}", data)
                      for i, v in enumerate(like))


def save_checkpoint(path, state, n_iter):
    """Save a solver state and its iteration counters to ``path`` (a
    directory; created). Returns the path."""
    path = str(path)
    os.makedirs(path, exist_ok=True)
    flat = _flatten({"state": state, "n_iter": n_iter}, "", {})
    arrays = {k[1:]: v.detach().cpu().numpy() for k, v in flat.items()}
    tmp = os.path.join(path, FILE + ".part")
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, os.path.join(path, FILE))
    return path


def restore_checkpoint(path, like):
    """Restore a checkpoint written by :func:`save_checkpoint`.

    ``like`` is a ``(state, n_iter)`` template, such as the state a solve
    returns: every tensor is placed on the device and dtype of its
    counterpart there. Returns ``(state, n_iter)``."""
    state_like, n_iter_like = like
    with np.load(os.path.join(str(path), FILE)) as data:
        data = {"." + k: data[k] for k in data.files}
    if set(data) != set(_flatten({"state": state_like,
                                  "n_iter": n_iter_like}, "", {})):
        raise ValueError(f"checkpoint {path} does not hold the template's "
                         "structure")
    return (_restore(state_like, ".state", data),
            _restore(n_iter_like, ".n_iter", data))
