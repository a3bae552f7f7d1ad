"""ML-VAMP's loop finish, what ``MLVAMPSolver._iterate`` does after its
step: the CUDA kernel's wrapper and its plain PyTorch version.

``ml_vamp_finish(pairs, sides, metric, flags, lanes, tol)`` takes

- ``pairs``: (next, carry) of every leaf of the loop's carry, next the
  step's output (``next is carry`` where the step passed a leaf through);
- ``sides``: ``(fa, ba, fb, bb)`` of every interface the stop metric reads,
  tensors of the carry or, at a pinned interface, the pinned message;
- ``metric``: the stop metric ``ratio(*side)`` of each interface, as the
  loop holds it; ``flags``, the loop's (``n_iter``, ``conv``, ``done``,
  ``count``: ``parallel/loop.py``); ``lanes``, B or None; ``tol``, a
  number.

In place it drops a step that is not finite and freezes a lane that is
done (the carry takes next where ``keep``: ``ok & ~done`` with lanes,
``ok`` without), writes the metric of the carry so kept into ``metric``,
and advances the flags (``lanes.advance``). It returns ``(ok, converged,
delta)``: ``ok`` where every element of next is finite, ``converged =
(delta < tol) & (count > 0)`` with ``count`` as it was before, and
``delta``, the largest over the interfaces of the metric's relative change
(root mean squares), one value per lane (0-d without lanes).

On the card it launches the hand-written kernel
(tramp_tpu_torch/csrc/ml_vamp_finish.cu, one launch for all lanes) and
counts the launch in ``ml_vamp_finish.launches``; the kernel advances each
lane's flags, and ``count`` is raised after it. The carry, the metric and
the flags are the plain version's bits, and delta's sums are taken in
another order (a few ulps). A state on the card that the kernel does not
take (``takes``) raises ValueError with the reason. CPU and meta tensors
run the plain version, the eager chain the solver ran before the kernel,
and count nothing.

The kernel is compiled with nvcc at its first launch into
``build/tramp_tpu_torch/``, one shared library for both floating types,
and loaded with ctypes on its own. Importing this module needs neither nvcc
nor a GPU.
"""
import ctypes
from collections import Counter

import torch

from .. import trace
from ..lanes import advance, per_lane, select_
from ._build import CSRC, build_library, stream

SOURCE = CSRC / "ml_vamp_finish.cu"
#: nvcc flags: no product contracted into a fused multiply-add, so that
#: every element rounds as the eager chain does
_FLAGS = ["-fmad=false"]
#: the kernel's table: leaves (carry leaves and pinned messages) and
#: interfaces (csrc/ml_vamp_finish.cu kMaxLeaves, kMaxSides; a relu layer
#: of a chain adds nine leaves and two interfaces)
MAX_LEAVES = 512
MAX_SIDES = 128
#: a leaf's flag: part of the finite test (a pinned message is not)
_CHECKED = 1

_C_TYPES = {torch.float32: "f32", torch.float64: "f64"}
#: the loop's flags (``loop.start_flags``) as the kernel reads and writes them
_FLAG_TYPES = {"n_iter": torch.int64, "conv": torch.bool, "done": torch.bool,
               "count": torch.int64}

# filled by build(): the C functions by dtype
_fns = {}


# -- plain version ----------------------------------------------------------

def ratio(fa, ba, fb, bb):
    """An interface's posterior mean, the loop's stop metric: (fb + bb) /
    (fa + ba), the precision held at the smallest normal number."""
    a = fa + ba
    b = fb + bb
    return b / torch.clamp(a, min=torch.finfo(a.dtype).tiny)


def _norm(x, B):
    "The root mean square of ``x``, one per lane."
    return torch.sqrt(per_lane(x**2, B).mean(-1))


def ml_vamp_finish_plain(pairs, sides, metric, flags, lanes, tol):
    "``ml_vamp_finish`` as plain tensor code: the solver's eager chain."
    B = lanes
    ok = torch.stack([torch.isfinite(per_lane(n, B)).all(-1)
                      for n, _ in pairs]).all(0)
    # a step that is not finite is dropped and ends its lane; a lane that
    # is done is frozen (without lanes the loop ends with it)
    active = ~flags["done"]
    keep = ok if B is None else ok & active
    for n, o in pairs:
        if n is not o:
            select_(keep, n, o)
    new_r = [ratio(*side) for side in sides]
    delta = torch.stack([
        _norm(n - o, B) / torch.clamp(
            _norm(n, B), min=torch.finfo(n.dtype).tiny)
        for n, o in zip(new_r, metric)]).amax(0)
    converged = (delta < tol) & (flags["count"] > 0)
    # a frozen lane's carry is unchanged, so its means computed again are
    # those it had, bit for bit: the copy keeps them
    for n, o in zip(new_r, metric):
        o.copy_(n)
    advance(flags, active, converged, ~ok)
    return ok, converged, delta


# -- which inputs the kernel takes ------------------------------------------

def _layout(t, lanes):
    """(elements a lane, lane stride) with which the kernel reads ``t``, or
    None where a lane of ``t`` is not one run of elements."""
    if lanes is None:
        return (t.numel(), 0) if t.is_contiguous() else None
    if t.ndim == 0 or t.shape[0] != lanes or not t[0].is_contiguous():
        return None
    return t[0].numel(), t.stride(0)


def _table(pairs, sides, metric, flags, lanes):
    """The kernel's leaves, as (next, carry or None, flags, (elements a
    lane, lane stride)), and each interface's (indices of fa, ba, fb, bb).
    Raises ValueError where they do not fit the kernel: flags other than 0-d
    without lanes and ``(lanes,)`` with them (``count`` 0-d), more than
    ``MAX_LEAVES`` leaves or ``MAX_SIDES`` interfaces, a lane that is not
    one run of elements, a carry leaf or metric that is not contiguous or
    shares its storage with another tensor, an interface's slot that is
    neither one value a lane nor as long as its metric, or a metric of
    another shape than its interface's."""
    shape = () if lanes is None else (lanes,)
    if any(tuple(flags[k].shape) != shape for k in ("n_iter", "conv", "done")
           ) or flags["count"].ndim != 0:
        raise ValueError(f"flags of shapes other than {shape} and ()")
    leaves, index = [], {}
    for n, o in pairs:
        if n is not o and n.shape != o.shape:
            raise ValueError(f"a step's leaf of shape {tuple(n.shape)} for "
                             f"a carry leaf of {tuple(o.shape)}")
        index[id(o)] = len(leaves)
        leaves.append([n, None if n is o else o, _CHECKED])
    slots = []
    for side in sides:
        at = []
        for t in side:
            if id(t) not in index:
                # a pinned message: read only
                index[id(t)] = len(leaves)
                leaves.append([t, None, 0])
            at.append(index[id(t)])
        slots.append(at)
    if not 0 < len(leaves) <= MAX_LEAVES:
        raise ValueError(f"{len(leaves)} leaves, past the table's "
                         f"{MAX_LEAVES}")
    if not 0 < len(sides) == len(metric) <= MAX_SIDES:
        raise ValueError(f"{len(sides)} interfaces and {len(metric)} metrics"
                         f" (the table takes 1 to {MAX_SIDES}, one each)")
    written = [c for _, c, _ in leaves if c is not None] + list(metric)
    if not all(w.is_contiguous() for w in written):
        raise ValueError("a carry leaf or metric that is not contiguous")
    storages = Counter(t.untyped_storage().data_ptr() for n, c, _ in leaves
                       for t in (n, c) if t is not None)
    storages.update(r.untyped_storage().data_ptr() for r in metric)
    if any(storages[w.untyped_storage().data_ptr()] > 1 for w in written):
        raise ValueError("a carry leaf or metric that shares its storage")
    for leaf in leaves:
        layout = _layout(leaf[0], lanes)
        if layout is None or layout[0] < 1:
            raise ValueError(f"a leaf of shape {tuple(leaf[0].shape)} and "
                             f"strides {leaf[0].stride()}, whose lane is not "
                             "one run of elements")
        leaf.append(layout)
    for side, at, r in zip(sides, slots, metric):
        n = _layout(r, lanes)
        if (n is None or r.shape != torch.broadcast_shapes(
                *(t.shape for t in side))
                or any(leaves[i][3][0] not in (1, n[0]) for i in at)):
            raise ValueError(f"a metric of shape {tuple(r.shape)} for an "
                             "interface of shapes "
                             f"{[tuple(t.shape) for t in side]}")
    return leaves, slots


def _tensors(pairs, sides, metric):
    "Every tensor of the finish's arguments but the flags."
    return ([t for pair in pairs for t in pair]
            + [t for side in sides for t in side] + list(metric))


def _card_types(tensors, flags):
    """Raises ValueError unless every tensor is on one CUDA device, of one
    floating type the kernel takes, and the flags of the loop's types
    (``loop.start_flags``) on that device."""
    dtype, device = tensors[0].dtype, tensors[0].device
    if device.type != "cuda" or dtype not in _C_TYPES:
        raise ValueError(f"a {dtype} state on {device}; the kernel takes "
                         "float32 or float64 on the card")
    if not all(t.dtype == dtype and t.device == device for t in tensors):
        kinds = sorted({(str(t.dtype), str(t.device)) for t in tensors})
        raise ValueError(f"a state of several types or devices: {kinds}")
    if not all(flags[k].dtype == t and flags[k].device == device
               for k, t in _FLAG_TYPES.items()):
        raise ValueError(f"flags of other types or devices than {device}'s "
                         f"{_FLAG_TYPES}")


def fits(pairs, sides, metric, flags, lanes):
    """Whether the loop state fits the kernel's table and layouts
    (``_table``) with its flags. Only shapes, strides and storages are
    read, so a state on the CPU is judged as the card's would be."""
    try:
        _table(pairs, sides, metric, flags, lanes)
    except ValueError:
        return False
    return True


def takes(pairs, sides, metric, flags, lanes):
    """Whether the kernel takes this loop state: on the card, of one type
    (float32 or float64), and within its table (``fits``)."""
    try:
        _card_types(_tensors(pairs, sides, metric), flags)
    except ValueError:
        return False
    return fits(pairs, sides, metric, flags, lanes)


# -- build ------------------------------------------------------------------

class _Leaf(ctypes.Structure):
    _fields_ = [("next", ctypes.c_void_p), ("carry", ctypes.c_void_p),
                ("n", ctypes.c_int64), ("next_lane", ctypes.c_int64),
                ("flags", ctypes.c_int64)]


class _Side(ctypes.Structure):
    _fields_ = [("fa", ctypes.c_int64), ("ba", ctypes.c_int64),
                ("fb", ctypes.c_int64), ("bb", ctypes.c_int64),
                ("r", ctypes.c_void_p), ("n", ctypes.c_int64)]


class _Head(ctypes.Structure):
    _fields_ = [("n_leaves", ctypes.c_int64), ("n_sides", ctypes.c_int64),
                ("laned", ctypes.c_int64), ("count", ctypes.c_void_p),
                ("n_iter", ctypes.c_void_p), ("conv", ctypes.c_void_p),
                ("done", ctypes.c_void_p), ("ok", ctypes.c_void_p),
                ("converged", ctypes.c_void_p), ("delta", ctypes.c_void_p),
                ("tol", ctypes.c_double)]


class _Finish(ctypes.Structure):
    "csrc/ml_vamp_finish.cu's struct Finish, field for field."
    _fields_ = [("head", _Head), ("leaf", _Leaf * MAX_LEAVES),
                ("side", _Side * MAX_SIDES)]


def build():
    """Compile the kernel with nvcc for sm_90a (once per content of the
    source and flags) and load it. Returns (path of the shared library,
    nvcc's diagnostics with ptxas's report). Spans as ``gb_prior.build``'s."""
    with trace.span("kernels.build"):
        lib_path, log = build_library(SOURCE, "ml_vamp_finish", _FLAGS)
        if not _fns:
            with trace.span("kernels.load"):
                lib = ctypes.CDLL(str(lib_path))
                for dtype, suffix in _C_TYPES.items():
                    fn = getattr(lib, f"ml_vamp_finish_{suffix}")
                    fn.argtypes = [ctypes.POINTER(_Finish), ctypes.c_int64,
                                   ctypes.c_void_p]
                    fn.restype = ctypes.c_int
                    _fns[dtype] = fn
        return lib_path, log


# -- wrapper ----------------------------------------------------------------

def ml_vamp_finish(pairs, sides, metric, flags, lanes, tol):
    """The loop's finish after a step (module docstring): in place on the
    carry leaves of ``pairs``, on ``metric`` and on ``flags``; returns
    ``(ok, converged, delta)``. One launch on the card, counted in
    ``ml_vamp_finish.launches``, and ``count`` raised; ValueError for a
    state on the card that the kernel does not take (``takes``);
    ``ml_vamp_finish_plain`` for CPU and meta tensors."""
    tensors = _tensors(pairs, sides, metric)
    if not any(t.device.type == "cuda" for t in tensors):
        return ml_vamp_finish_plain(pairs, sides, metric, flags, lanes, tol)
    try:
        _card_types(tensors, flags)
        leaves, slots = _table(pairs, sides, metric, flags, lanes)
    except ValueError as e:
        raise ValueError(f"ml_vamp_finish: the kernel does not take {e}"
                         ) from None
    if not _fns:
        build()
    dtype, device = metric[0].dtype, metric[0].device
    shape = () if lanes is None else (lanes,)
    out = torch.empty((2,) + shape, dtype=torch.bool, device=device)
    delta = torch.empty(shape, dtype=dtype, device=device)
    p = _Finish(head=_Head(
        n_leaves=len(leaves), n_sides=len(sides),
        laned=int(lanes is not None), count=flags["count"].data_ptr(),
        n_iter=flags["n_iter"].data_ptr(), conv=flags["conv"].data_ptr(),
        done=flags["done"].data_ptr(), ok=out[0].data_ptr(),
        converged=out[1].data_ptr(), delta=delta.data_ptr(),
        tol=float(tol)))
    for i, (n, c, kind, (length, lane)) in enumerate(leaves):
        p.leaf[i] = _Leaf(n.data_ptr(), None if c is None else c.data_ptr(),
                          length, lane, kind)
    for i, (at, r) in enumerate(zip(slots, metric)):
        p.side[i] = _Side(*at, r.data_ptr(), _layout(r, lanes)[0])
    err = _fns[dtype](ctypes.byref(p), 1 if lanes is None else lanes,
                      stream(device))
    if err != 0:
        raise RuntimeError(f"ml_vamp_finish kernel launch failed: CUDA error "
                           f"{err}")
    ml_vamp_finish.launches += 1
    # the kernel read count; every lane's flags are advanced
    flags["count"] += 1
    return out[0], out[1], delta


ml_vamp_finish.launches = 0
