"""The isotropic Gauss-Bernoulli prior's posterior and EP message: the CUDA
kernel's wrappers and their plain PyTorch versions.

- ``gb_posterior(ax, bx, a0, b0, eta)`` returns ``(r, v)``: the prior's
  posterior mean of every element and the isotropic mean of its variance,
  one value per lane (``GaussBernoulliPrior.compute_forward_posterior``
  with ``isotropic``).
- ``gb_message(ax, bx, a0, b0, eta)`` returns ``(a_new, b_new)``: the
  forward EP message, that posterior followed by ``base.compute_ab_new``
  (``Prior.compute_forward_message``).

``a0 = 1 / var``, ``b0 = mean / var`` and ``eta`` are the prior's
(``GaussBernoulliPrior.a``, ``.b``, ``.eta``): Python numbers, or one value
per lane. ``ax`` is 0-d or one value per lane of ``bx``
(tramp_tpu_torch/lanes.py); the lane mean is taken as ``lane_mean`` takes
it, per lane where ``ax`` has lanes, else over all of ``bx``.

On CUDA tensors a wrapper launches the hand-written kernel
(tramp_tpu_torch/csrc/gb_prior.cu, one launch for all lanes) or raises, and
counts the launch in ``<wrapper>.launches``. On any other device (the CPU,
and the meta tensors of the solvers' shape sweeps) it runs the plain
version, the eager chain the prior ran before the kernel, bit for bit, and
counts nothing. ``takes`` says which inputs the kernel takes; the prior
sends only those to the wrappers and the rest to the plain versions. A
bfloat16 input raises, as in ``pl_fused``.

The kernel is compiled with nvcc at its first launch into
``build/tramp_tpu_torch/``, one shared library for both floating types,
named by the content of its source and flags, and loaded with ctypes on its
own: a program that runs only this prior loads no other kernel library.
Importing this module needs neither nvcc nor a GPU.
"""
import ctypes
import hashlib
import numbers
import os
import subprocess

import torch

from .. import config, trace
from ..base import compute_ab_new
from ..beliefs import sparse
from ..lanes import lane_count, lane_mean
from ._build import BUILD_DIR, CSRC, nvcc_command, refuse_bf16, stream

SOURCE = CSRC / "gb_prior.cu"
#: nvcc flags: no product contracted into a fused multiply-add, so that
#: every element rounds as the eager chain does (csrc/gb_prior.cu)
_FLAGS = ["-fmad=false"]

_C_TYPES = {torch.float32: "f32", torch.float64: "f64"}
_POSTERIOR, _MESSAGE = 0, 1

# filled by build(): the C functions by dtype
_fns = {}


# -- plain versions ---------------------------------------------------------

def gb_posterior_plain(ax, bx, a0, b0, eta):
    """(r, v) as plain tensor code: the eager chain of
    ``GaussBernoulliPrior.compute_forward_posterior`` with the isotropic
    lane mean."""
    a = ax + a0
    b = bx + b0
    rx = sparse.r(a, b, eta)
    vx = sparse.v(a, b, eta)
    return rx, lane_mean(vx, ax)


def gb_message_plain(ax, bx, a0, b0, eta):
    """(a_new, b_new) as plain tensor code: ``gb_posterior_plain`` and
    ``compute_ab_new`` against (ax, bx), as ``Prior.compute_forward_message``
    computes them."""
    rx, vx = gb_posterior_plain(ax, bx, a0, b0, eta)
    return compute_ab_new(rx, vx, ax, bx)


# -- which inputs the kernel takes ------------------------------------------

def _lanes(ax, bx):
    "B where ax is one value per lane of bx, 1 where it is 0-d, else None."
    if not isinstance(ax, torch.Tensor):
        return None
    if ax.ndim == 0:
        return 1
    return lane_count(ax, bx)


def _hyper_ok(h, ax, bx):
    """A hyperparameter the kernel reads: a number, or a tensor of bx's type
    on its device, 0-d or, where ax is one value per lane, one value per
    lane as ax is (a shape that broadcasts to neither ax's nor bx's)."""
    if isinstance(h, numbers.Real) and not isinstance(h, bool):
        return True
    if not (isinstance(h, torch.Tensor) and h.dtype == bx.dtype
            and h.device == bx.device):
        return False
    return h.ndim == 0 or (ax.ndim > 0 and h.shape == ax.shape)


def takes(ax, bx, a0, b0, eta):
    """Whether the kernel takes these inputs: ``bx`` float32 or float64 and
    not empty, ``ax`` a tensor of its type on its device, 0-d or one value
    per lane, and each hyperparameter a number or a tensor of bx's type and
    device with one value, or one per lane. A lane may have any length.
    Only shapes, types and devices are read, so meta tensors are judged as
    the card's would be."""
    if not (isinstance(bx, torch.Tensor) and bx.dtype in _C_TYPES
            and isinstance(ax, torch.Tensor) and ax.dtype == bx.dtype
            and ax.device == bx.device):
        return False
    lanes = _lanes(ax, bx)
    if lanes is None or bx.numel() == 0:
        return False
    return all(_hyper_ok(h, ax, bx) for h in (a0, b0, eta))


# -- build ------------------------------------------------------------------

def build():
    """Compile the kernel with nvcc for sm_90a (once per content of the
    source and flags) and load it. Returns (path of the shared library,
    nvcc's diagnostics, which hold ptxas's register and spill report,
    ``_build.ptxas_report``; kept beside the library, so a later build
    returns them too). Spans as ``pl_fused.build``'s."""
    with trace.span("kernels.build"):
        return _build()


def _build():
    tag = hashlib.sha256(SOURCE.read_bytes()
                         + " ".join(_FLAGS).encode()).hexdigest()[:16]
    lib_path = BUILD_DIR / f"libgb_prior_{tag}.so"
    log_path = BUILD_DIR / f"libgb_prior_{tag}.log"
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
        with trace.span("kernels.compile"):
            proc = subprocess.run(nvcc_command(SOURCE, tmp, *_FLAGS),
                                  capture_output=True, text=True,
                                  check=False)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed with code {proc.returncode} on "
                               f"{lib_path.name}:\n{log}")
        log_path.write_text(log)
        os.replace(tmp, lib_path)
    if not _fns:
        with trace.span("kernels.load"):
            _fns.update(_load(lib_path))
    return lib_path, log_path.read_text() if log_path.exists() else ""


def _load(lib_path):
    "The C functions of the built library, by dtype."
    ptr, i64, dbl = ctypes.c_void_p, ctypes.c_int64, ctypes.c_double
    lib = ctypes.CDLL(str(lib_path))
    fns = {}
    for dtype, suffix in _C_TYPES.items():
        fn = getattr(lib, f"gb_prior_{suffix}")
        fn.argtypes = [ctypes.c_int, ptr, i64, ptr,
                       dbl, ptr, i64, dbl, ptr, i64, dbl, ptr, i64,
                       ptr, ptr, i64, i64, ctypes.c_int, dbl, dbl, dbl, ptr]
        fn.restype = ctypes.c_int
        fns[dtype] = fn
    return fns


# -- wrappers ---------------------------------------------------------------

def _lane_stride(a):
    "The stride between lanes with which the kernel reads a tensor per lane."
    return 0 if a.ndim == 0 else a.stride(0)


def _hyper(h):
    "(value, pointer, lane stride) of a hyperparameter for the C interface."
    if isinstance(h, torch.Tensor):
        return 0.0, h.data_ptr(), _lane_stride(h)
    return float(h), None, 0


def _launch(wrapper, kind, ax, bx, a0, b0, eta):
    what = wrapper.__name__
    if not takes(ax, bx, a0, b0, eta):
        raise ValueError(f"{what}: the kernel does not take these inputs "
                         "(gb_prior.takes)")
    if not _fns:
        build()
    bx = bx.contiguous()
    lanes = _lanes(ax, bx)
    n = bx.numel() // lanes
    width = 16 // bx.element_size()
    vec = int(n % width == 0 and bx.data_ptr() % 16 == 0)
    out = torch.empty_like(bx)
    per_lane = torch.empty(ax.shape, dtype=bx.dtype, device=bx.device)
    err = _fns[bx.dtype](
        kind, ax.data_ptr(), _lane_stride(ax), bx.data_ptr(),
        *_hyper(a0), *_hyper(b0), *_hyper(eta), per_lane.data_ptr(),
        out.data_ptr(), n, lanes, vec, config.VMIN, config.AMIN,
        config.AMAX, stream(bx.device))
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")
    wrapper.launches += 1
    return out, per_lane


def gb_posterior(ax, bx, a0, b0, eta):
    """The isotropic Gauss-Bernoulli posterior ``(r, v)``: r of ``bx``'s
    shape, v one value per lane (``ax``'s shape; 0-d without lanes).

    On CUDA tensors this launches the kernel for all lanes at once and
    counts the launch in ``gb_posterior.launches``; it raises on inputs the
    kernel does not take (``takes``). On other devices it is
    ``gb_posterior_plain``."""
    refuse_bf16("gb_posterior", ax, bx, a0, b0, eta)
    if bx.device.type != "cuda":
        return gb_posterior_plain(ax, bx, a0, b0, eta)
    return _launch(gb_posterior, _POSTERIOR, ax, bx, a0, b0, eta)


def gb_message(ax, bx, a0, b0, eta):
    """The prior's forward EP message ``(a_new, b_new)``: a_new one value
    per lane (``ax``'s shape), b_new of ``bx``'s shape. Devices, errors and
    counts as ``gb_posterior``'s, in ``gb_message.launches``; off CUDA it is
    ``gb_message_plain``."""
    refuse_bf16("gb_message", ax, bx, a0, b0, eta)
    if bx.device.type != "cuda":
        return gb_message_plain(ax, bx, a0, b0, eta)
    b_new, a_new = _launch(gb_message, _MESSAGE, ax, bx, a0, b0, eta)
    return a_new, b_new


gb_posterior.launches = 0
gb_message.launches = 0
