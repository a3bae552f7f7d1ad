"""Fused piecewise-linear posterior and messages: the CUDA kernels'
wrappers and their plain PyTorch twins.

Counterpart of tramp_tpu/ops/pl_fused.py. For every element and every
linear region ``x = x0 + slope * z`` with ``z in [zmin, zmax]`` the
posterior computes the tilted truncated-normal moments, the per-region
log-partitions and the softmax merge over regions for both the backward (z)
and forward (x) posteriors, plus the total log-partition.

- ``pl_posterior`` returns the five streams (rz, vz, rx, vx, logZ), as the
  TPU kernel does (tramp_tpu_torch/csrc/pl_posterior.cu).
- ``pl_forward_message`` / ``pl_backward_message`` return the EP message
  (a_new, b_new) of one direction: the posterior of that side, the
  isotropic mean of its variance and the moment-matching update
  ``base.compute_ab_new`` in one kernel (tramp_tpu_torch/csrc/pl_message.cu).

On CUDA tensors a wrapper launches its hand-written Hopper kernel or raises;
on CPU tensors it runs its plain twin (``*_plain``), which is also the
kernel's oracle; on meta tensors it returns empty outputs of the right
shapes (the engine's shape sweep). Each wrapper counts the kernels it
launches in a plain integer, ``<wrapper>.launches``. A bfloat16 input
raises on every device: the engine's bfloat16 message state
(``config.STATE_BF16``) is upcast before any factor reads it, and a
wrapper never converts one.

Lanes (tramp_tpu_torch/lanes.py). ``bz`` and ``bx`` may carry a first lane
axis, ``(B, n)``, with a precision per lane, ``(B, 1)``: the JAX kernel gets
the same from ``jax.vmap``. A precision is then read as ``a[lane]`` on the
device (no ``(B, n)`` copy of it is made), and a message takes its mean,
its update and its clamps per lane: ``a_new`` is ``(B, 1)``. There are
lanes when either precision is one value per lane; the other may be one
number for all lanes or one per element. On the card lane i of a batched
message is bit-identical to the single call on lane i's data (a lane's sums
are those of the single launch, term by term, whether the lanes run one
block each, up to LANE_MAX elements, or one cluster each, and an element
is computed by the same code with its rounding written out); on the CPU the
plain versions agree to rtol 1e-13
(``torch.mean`` along an axis may sum in another order than over a whole
array). The launch count does not depend on B.

The kernels are compiled with nvcc at their first launch into
``build/tramp_tpu_torch/`` beside the package: one shared library with a
plain C interface per source and floating type, all compiled at once, named
by the content of the sources and loaded with ctypes. Importing this module
needs neither nvcc nor a GPU.
"""
import ctypes
import hashlib
import math
import os
import subprocess
from pathlib import Path

import torch

from .. import config, trace
from ..base import compute_ab_new
from ..lanes import lane_count, lane_mean
from ..utils.truncated_normal import (
    truncated_normal_mean, truncated_normal_var, truncated_normal_logZ,
)
# (ptxas_report is read as pl_fused.ptxas_report too)
from ._build import (  # noqa: F401
    BUILD_DIR, CSRC, nvcc_command, ptxas_report, refuse_bf16, stream)

HEADER = CSRC / "pl_common.cuh"
SOURCES = {"pl_posterior": CSRC / "pl_posterior.cu",
           "pl_message": CSRC / "pl_message.cu"}
#: nvcc flags of one source: the message kernels contract no product into a
#: fused multiply-add on their own (csrc/pl_common.cuh writes out the ones
#: it takes), so that every layout gives an element the same bits
_FLAGS = {"pl_posterior": [], "pl_message": ["-fmad=false"]}
MAX_REGIONS = 8
#: most elements the message kernel takes in one launch (kClusterMax in
#: csrc/pl_message.cu), per lane; above it the message is two launches with
#: a scratch array of at most MAX_PARTIALS doubles per lane, one per block
#: of the first launch (the card holds fewer blocks than that at once)
CLUSTER_MAX = 16384
MAX_PARTIALS = 2048
#: most elements a lane has where a message with lanes is one block per lane
#: (kLaneMax in csrc/pl_message.cu); above it, up to CLUSTER_MAX, it is one
#: cluster per lane
LANE_MAX = 4096
#: threads of a block of the message kernel (kThreads in csrc/pl_message.cu)
_BLOCK = 512

_C_TYPES = {torch.float32: ("f32", ctypes.c_float),
            torch.float64: ("f64", ctypes.c_double)}
_FORWARD, _BACKWARD = 0, 1

# filled by build(): C functions by (name, dtype), and the launch-floor probe
_fns = {}
# region specs in the kernels' layout, by (specs, dtype)
_spec_arrays = {}


# -- plain versions ---------------------------------------------------------

def pl_posterior_plain(az, bz, ax, bx, specs):
    """Elementwise fused PL posterior as plain tensor code (any device).

    A line-for-line port of tramp_tpu/ops/pl_fused.py:40-78. Returns
    (rz, vz, rx, vx, logZ), all with the shape of ``bz``; no isotropic
    reduction is applied. ``specs`` is a tuple of (zmin, zmax, x0, slope)
    region parameters (Python floats, possibly +-inf)."""
    az = torch.as_tensor(az, dtype=bz.dtype, device=bz.device)
    ax = torch.as_tensor(ax, dtype=bz.dtype, device=bz.device)
    rzs, vzs, rxs, vxs, As = [], [], [], [], []
    for (zmin, zmax, x0, slope) in specs:
        a = az + slope**2 * ax
        b = bz + slope * (bx - ax * x0)
        r0, v0 = b / a, 1.0 / a
        rz_k = truncated_normal_mean(r0, v0, zmin, zmax)
        vz_k = truncated_normal_var(r0, v0, zmin, zmax)
        rzs.append(rz_k)
        vzs.append(vz_k)
        rxs.append(slope * rz_k + x0)
        vxs.append(slope**2 * vz_k)
        As.append(truncated_normal_logZ(r0, v0, zmin, zmax)
                  - 0.5 * ax * x0**2 + bx * x0)

    A_max = As[0]
    for A_k in As[1:]:
        A_max = torch.maximum(A_max, A_k)
    ws = [torch.exp(A_k - A_max) for A_k in As]
    Z = sum(ws)
    ps = [w / Z for w in ws]
    logZ = A_max + torch.log(Z)

    def merge(r_ks, v_ks):
        r = sum(p * r_k for p, r_k in zip(ps, r_ks))
        Dr = sum(p * r_k**2 for p, r_k in zip(ps, r_ks)) - r**2
        return r, sum(p * v_k for p, v_k in zip(ps, v_ks)) + Dr

    rz, vz = merge(rzs, vzs)
    rx, vx = merge(rxs, vxs)
    return rz, vz, rx, vx, logZ


def pl_forward_message_plain(az, bz, ax, bx, specs):
    """Forward EP message (a_new, b_new) as plain tensor code: the x
    posterior of ``pl_posterior_plain``, the mean of its variance (per lane
    when a precision is per lane), and ``compute_ab_new`` against
    (ax, bx)."""
    _, _, rx, vx, _ = pl_posterior_plain(az, bz, ax, bx, specs)
    return compute_ab_new(rx, lane_mean(vx, az, ax), ax, bx)


def pl_backward_message_plain(az, bz, ax, bx, specs):
    """Backward EP message (a_new, b_new) as plain tensor code: the z
    posterior of ``pl_posterior_plain``, the mean of its variance (per lane
    when a precision is per lane), and ``compute_ab_new`` against
    (az, bz)."""
    rz, vz, _, _, _ = pl_posterior_plain(az, bz, ax, bx, specs)
    return compute_ab_new(rz, lane_mean(vz, az, ax), az, bz)


# -- build ------------------------------------------------------------------

def build():
    """Compile the kernels with nvcc for sm_90a (once per content of the
    sources; the missing libraries are all compiled at the same time) and
    load them. Returns (paths of the shared libraries, nvcc's diagnostics,
    which hold ptxas's register and spill report; empty for a library that
    was already built). The span ``kernels.build`` holds a
    ``kernels.compile`` per library built and ``kernels.load``."""
    with trace.span("kernels.build"):
        return _build()


def _build():
    header = HEADER.read_bytes()
    jobs = []
    for name, source in SOURCES.items():
        tag = hashlib.sha256(header + source.read_bytes() + " ".join(
            _FLAGS[name]).encode()).hexdigest()[:16]
        for dtype, (suffix, _) in _C_TYPES.items():
            jobs.append((name, dtype, suffix, source,
                         BUILD_DIR / f"lib{name}_{suffix}_{tag}.so"))
    running = []
    for name, _, suffix, source, lib_path in jobs:
        if lib_path.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
        cmd = nvcc_command(source, tmp, f"-DPL_{suffix.upper()}_ONLY",
                           *_FLAGS[name])
        # diagnostics to a file: a pipe could fill while another job is
        # waited for
        with open(f"{tmp}.log", "w") as diagnostics:
            running.append((lib_path, tmp, subprocess.Popen(
                cmd, stdout=diagnostics, stderr=subprocess.STDOUT)))
    log = ""
    failures = []
    for lib_path, tmp, proc in running:
        with trace.span("kernels.compile"):
            proc.wait()
        stderr = Path(f"{tmp}.log").read_text()
        os.remove(f"{tmp}.log")
        if proc.returncode != 0:
            failures.append(f"nvcc failed with code {proc.returncode} on "
                            f"{lib_path.name}:\n{stderr}")
            continue
        os.replace(tmp, lib_path)
        log += stderr
    if failures:
        raise RuntimeError("\n".join(failures))
    if not _fns:
        with trace.span("kernels.load"):
            _fns.update(_load(jobs))
    return [job[-1] for job in jobs], log


def _load(jobs):
    "The C functions of the built libraries, by (name, dtype)."
    ptr, i64, dbl = ctypes.c_void_p, ctypes.c_int64, ctypes.c_double
    fns = {}
    for name, dtype, suffix, _, lib_path in jobs:
        lib = ctypes.CDLL(str(lib_path))
        fn = getattr(lib, f"{name}_{suffix}")
        if name == "pl_posterior":
            fn.argtypes = ([ptr, i64, i64, ptr, ptr, i64, i64, ptr]
                           + [ptr] * 5
                           + [i64, i64, ptr, ctypes.c_int, ptr])
            lib.pl_launch_floor.argtypes = [ptr]
            lib.pl_launch_floor.restype = ctypes.c_int
            fns["pl_launch_floor"] = lib.pl_launch_floor
        else:
            fn.argtypes = ([ctypes.c_int, ptr, i64, i64, ptr, ptr, i64,
                            i64, ptr]
                           + [ptr, ctypes.c_int, ptr, ptr, i64, i64, i64,
                              ptr, ctypes.c_int, dbl, dbl, dbl, ptr])
        fn.restype = ctypes.c_int
        fns[name, dtype] = fn
    return fns


# -- wrappers ---------------------------------------------------------------

def _spec_array(specs, dtype):
    """The regions in the kernels' own type and layout, converted once per
    (specs, dtype): per region zmin, zmax, x0, slope, slope^2, x0^2 and the
    interval's kind (0 both bounds infinite, 1 upper, 2 lower, 3 neither)."""
    key = (specs, dtype)
    array = _spec_arrays.get(key)
    if array is None:
        flat = []
        for zmin, zmax, x0, slope in specs:
            lo_inf, hi_inf = zmin == -math.inf, zmax == math.inf
            kind = 0 if lo_inf and hi_inf else 1 if hi_inf else \
                2 if lo_inf else 3
            flat += [zmin, zmax, x0, slope, slope * slope, x0 * x0, kind]
        array = (_C_TYPES[dtype][1] * len(flat))(*flat)
        _spec_arrays[key] = array
    return array


def _precision(a, bz, name):
    """A precision as a tensor on bz's device: one element, one value per
    lane of bz (``(B, 1, ...)``), or bz's shape."""
    if not isinstance(a, torch.Tensor):
        return torch.as_tensor(a, dtype=bz.dtype, device=bz.device)
    if a.device != bz.device or a.dtype != bz.dtype:
        raise ValueError(f"{name} is {a.dtype} on {a.device}, "
                         f"bz is {bz.dtype} on {bz.device}")
    if (a.numel() != 1 and a.shape != bz.shape
            and lane_count(a, bz) is None):
        raise ValueError(f"{name} has shape {tuple(a.shape)}: need a "
                         f"scalar, one value per lane, or bz's shape "
                         f"{tuple(bz.shape)}")
    if not a.is_contiguous():
        raise ValueError(f"{name} is not contiguous")
    return a


def _checked(what, az, bz, ax, bx, specs):
    """Raise on anything the kernels do not take; returns az and ax as
    tensors on bz's device."""
    if bz.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {bz.device}")
    if bz.dtype not in _C_TYPES:
        raise ValueError(f"{what}: unsupported dtype {bz.dtype}")
    if bx.device != bz.device or bx.dtype != bz.dtype or bx.shape != bz.shape:
        raise ValueError(f"{what}: bx must match bz in device, dtype "
                         "and shape")
    if not (bz.is_contiguous() and bx.is_contiguous()):
        raise ValueError(f"{what}: bz and bx must be contiguous")
    if not 1 <= len(specs) <= MAX_REGIONS:
        raise ValueError(f"{what}: need 1 to {MAX_REGIONS} regions")
    return _precision(az, bz, "az"), _precision(ax, bz, "ax")


def _lanes(az, bz, ax):
    "Lanes of a call: B when either precision is per lane of bz, else None."
    counts = [lane_count(a, bz) for a in (az, ax)]
    return next((B for B in counts if B is not None), None)


def _strides(a, bz, lanes):
    """(element stride, lane stride) with which the kernels read a
    precision: element e of lane l is ``a[l * lane stride + e * element
    stride]``."""
    if a.numel() == 1:
        return 0, 0
    if a.shape == bz.shape and lane_count(a, bz) is None:
        return 1, bz.numel() // (lanes or 1)
    return 0, 1


def pl_posterior(az, bz, ax, bx, specs):
    """Fused PL posterior (rz, vz, rx, vx, logZ), elementwise in ``bz``.

    On CUDA tensors this launches the hand-written kernel (float32 or
    float64) and counts the launch in ``pl_posterior.launches``; it raises on
    anything the kernel does not take. On CPU tensors it is
    ``pl_posterior_plain``. On meta tensors it returns outputs of the right
    shape and dtype (the engine's shape sweep). ``az``/``ax`` are scalars,
    one value per lane of ``bz`` (``(B, 1)`` with ``bz`` of ``(B, n)``), or
    arrays of ``bz``'s shape; ``bx`` has ``bz``'s shape. The five outputs are
    views of one allocation."""
    refuse_bf16("pl_posterior", az, bz, ax, bx)
    if bz.device.type == "cpu":
        return pl_posterior_plain(az, bz, ax, bx, specs)
    if bz.device.type == "meta":
        return tuple(torch.empty_like(bz) for _ in range(5))
    az, ax = _checked("pl_posterior", az, bz, ax, bx, specs)
    if not _fns:
        build()
    lanes = _lanes(az, bz, ax)
    total = bz.numel()
    out = torch.empty((5,) + bz.shape, dtype=bz.dtype, device=bz.device)
    first, step = out.data_ptr(), total * out.element_size()
    err = _fns["pl_posterior", bz.dtype](
        az.data_ptr(), *_strides(az, bz, lanes), bz.data_ptr(),
        ax.data_ptr(), *_strides(ax, bz, lanes), bx.data_ptr(), first,
        first + step, first + 2 * step, first + 3 * step, first + 4 * step,
        total // (lanes or 1), lanes or 1, _spec_array(specs, bz.dtype),
        len(specs), stream(bz.device))
    if err != 0:
        raise RuntimeError(f"pl_posterior kernel launch failed: CUDA error "
                           f"{err}")
    pl_posterior.launches += 1
    return out.unbind(0)


pl_posterior.launches = 0


def _a_new_shape(own, bz, lanes):
    """Shape of a message's a_new, as the plain version gives it: bz's for
    a precision per element, one value per lane with lanes, else the own
    precision's."""
    if isinstance(own, torch.Tensor) and own.numel() != 1 \
            and lane_count(own, bz) is None:
        return bz.shape
    if lanes is not None:
        return (lanes,) + (1,) * (bz.ndim - 1)
    return own.shape if isinstance(own, torch.Tensor) else ()


def _message_outputs(side, az, bz, ax):
    """(a_new, b_new, partials) of a message call on bz's device: the two
    outputs, and the scratch array of block sums of the two-launch path,
    one row per lane (None where the call is one launch: up to CLUSTER_MAX
    elements per lane)."""
    lanes = _lanes(az, bz, ax)
    own = ax if side == _FORWARD else az
    a_new = torch.empty(_a_new_shape(own, bz, lanes), dtype=bz.dtype,
                        device=bz.device)
    b_new = torch.empty_like(bz)
    n = bz.numel() // (lanes or 1)
    if n <= CLUSTER_MAX:
        return a_new, b_new, None
    # the row's length bounds the first launch's blocks per lane, as it
    # does without lanes
    partials = torch.empty((lanes or 1, min(-(-n // _BLOCK), MAX_PARTIALS)),
                           dtype=torch.float64, device=bz.device)
    return a_new, b_new, partials


def _message(wrapper, plain, side, az, bz, ax, bx, specs):
    refuse_bf16(wrapper.__name__, az, bz, ax, bx)
    if bz.device.type == "cpu":
        return plain(az, bz, ax, bx, specs)
    if bz.device.type == "meta":
        return _message_outputs(side, az, bz, ax)[:2]
    what = wrapper.__name__
    az, ax = _checked(what, az, bz, ax, bx, specs)
    if bz.numel() == 0:
        raise ValueError(f"{what}: the mean of no element is undefined")
    lanes = _lanes(az, bz, ax)
    if not _fns:
        build()
    a_new, b_new, partials = _message_outputs(side, az, bz, ax)
    err = _fns["pl_message", bz.dtype](
        side, az.data_ptr(), *_strides(az, bz, lanes), bz.data_ptr(),
        ax.data_ptr(), *_strides(ax, bz, lanes), bx.data_ptr(),
        a_new.data_ptr(), int(a_new.shape == bz.shape),
        b_new.data_ptr(), None if partials is None else partials.data_ptr(),
        0 if partials is None else partials.shape[1],
        bz.numel() // (lanes or 1), lanes or 1,
        _spec_array(specs, bz.dtype), len(specs), config.VMIN, config.AMIN,
        config.AMAX, stream(bz.device))
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")
    wrapper.launches += 1 if partials is None else 2
    return a_new, b_new


def pl_forward_message(az, bz, ax, bx, specs):
    """Forward EP message (a_new, b_new) of a piecewise-linear channel:
    x posterior, mean of its variance and ``compute_ab_new`` against
    (ax, bx), fused.

    On CUDA tensors this launches the message kernel (one launch up to
    16384 elements per lane, two above, whatever the number of lanes) and
    counts its launches in ``pl_forward_message.launches``; it raises on
    anything the kernel does not take. On CPU tensors it is
    ``pl_forward_message_plain``; on meta tensors it returns empty outputs of
    the right shapes. ``a_new`` has ``ax``'s shape (0-d for a scalar
    precision, ``(B, 1)`` with lanes), ``b_new`` has ``bz``'s."""
    return _message(pl_forward_message, pl_forward_message_plain, _FORWARD,
                    az, bz, ax, bx, specs)


def pl_backward_message(az, bz, ax, bx, specs):
    """Backward EP message (a_new, b_new) of a piecewise-linear channel:
    z posterior, mean of its variance and ``compute_ab_new`` against
    (az, bz), fused. Devices, errors and shapes as ``pl_forward_message``,
    with ``a_new`` in ``az``'s shape; counts in
    ``pl_backward_message.launches``."""
    return _message(pl_backward_message, pl_backward_message_plain,
                    _BACKWARD, az, bz, ax, bx, specs)


pl_forward_message.launches = 0
pl_backward_message.launches = 0

#: the JAX package's names for the five-output entry point and its twin
fused_pl_posterior = pl_posterior
pl_posterior_reference = pl_posterior_plain


def launch_floor():
    """Launch an empty kernel on the current stream: its time is the floor
    under the time of any launch on this card and host."""
    if not _fns:
        build()
    err = _fns["pl_launch_floor"](
        stream(torch.device("cuda", torch.cuda.current_device())))
    if err != 0:
        raise RuntimeError(f"empty kernel launch failed: CUDA error {err}")
