"""Fused piecewise-linear posterior: the CUDA kernel's wrapper and its
plain PyTorch twin.

Counterpart of tramp_tpu/ops/pl_fused.py. For every element and every
linear region ``x = x0 + slope * z`` with ``z in [zmin, zmax]`` it computes
the tilted truncated-normal moments, the per-region log-partitions and the
softmax merge over regions for both the backward (z) and forward (x)
posteriors, plus the total log-partition. ``pl_posterior`` launches the
hand-written Hopper kernel tramp_tpu_torch/csrc/pl_posterior.cu on CUDA
tensors; ``pl_posterior_plain`` is the same math as plain tensor code, used
for CPU tensors and as the kernel's oracle.

The kernel is compiled with nvcc at its first launch into
``build/tramp_tpu_torch/`` beside the package (one shared library with a
plain C interface per source content, loaded with ctypes), so importing this
module needs neither nvcc nor a GPU.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from ..utils.truncated_normal import (
    truncated_normal_mean, truncated_normal_var, truncated_normal_logZ,
)

_PACKAGE = Path(__file__).resolve().parents[1]
SOURCE = _PACKAGE / "csrc" / "pl_posterior.cu"
BUILD_DIR = _PACKAGE.parent / "build" / "tramp_tpu_torch"
MAX_REGIONS = 8

_lib = None


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


def build():
    """Compile the kernel with nvcc for sm_90a (once per source content)
    and load it. Returns (path of the shared library, nvcc's diagnostics,
    which hold ptxas's register and spill report; empty when the library
    was already built)."""
    global _lib
    tag = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    lib_path = BUILD_DIR / f"libpl_posterior_{tag}.so"
    log = ""
    if not lib_path.exists():
        from torch.utils.cpp_extension import CUDA_HOME
        nvcc = shutil.which("nvcc") or (
            CUDA_HOME and os.path.join(CUDA_HOME, "bin", "nvcc"))
        if not nvcc or not os.path.exists(nvcc):
            raise RuntimeError("nvcc not found: the CUDA toolkit is needed "
                               "to build tramp_tpu_torch's kernels")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", "-o", str(tmp), str(SOURCE)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed with code {proc.returncode}:\n{proc.stderr}")
        os.replace(tmp, lib_path)
        log = proc.stderr
    if _lib is None:
        lib = ctypes.CDLL(str(lib_path))
        ptr, i64 = ctypes.c_void_p, ctypes.c_int64
        for fn in (lib.pl_posterior_f32, lib.pl_posterior_f64):
            fn.argtypes = ([ptr, i64, ptr, ptr, i64, ptr] + [ptr] * 5
                           + [i64, ptr, ctypes.c_int, ptr])
            fn.restype = ctypes.c_int
        _lib = lib
    return lib_path, log


def _precision(a, bz, name):
    "A precision as a tensor on bz's device: 0-d/one element, or bz's shape."
    if not isinstance(a, torch.Tensor):
        return torch.as_tensor(a, dtype=bz.dtype, device=bz.device)
    if a.device != bz.device or a.dtype != bz.dtype:
        raise ValueError(f"{name} is {a.dtype} on {a.device}, "
                         f"bz is {bz.dtype} on {bz.device}")
    if a.numel() != 1 and a.shape != bz.shape:
        raise ValueError(f"{name} has shape {tuple(a.shape)}: need a scalar "
                         f"or bz's shape {tuple(bz.shape)}")
    if not a.is_contiguous():
        raise ValueError(f"{name} is not contiguous")
    return a


def pl_posterior(az, bz, ax, bx, specs):
    """Fused PL posterior (rz, vz, rx, vx, logZ), elementwise in ``bz``.

    On CUDA tensors this launches the hand-written kernel (float32 or
    float64) and counts the launch in ``pl_posterior.launches``; it raises on
    anything the kernel does not take. On CPU tensors it is
    ``pl_posterior_plain``. On meta tensors it returns outputs of the right
    shape and dtype (the engine's shape sweep). ``az``/``ax`` are scalars or
    arrays of ``bz``'s shape; ``bx`` has ``bz``'s shape."""
    if bz.device.type == "cpu":
        return pl_posterior_plain(az, bz, ax, bx, specs)
    if bz.device.type == "meta":
        return tuple(torch.empty_like(bz) for _ in range(5))
    if bz.device.type != "cuda":
        raise ValueError(f"pl_posterior: unsupported device {bz.device}")
    if bz.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"pl_posterior: unsupported dtype {bz.dtype}")
    if bx.device != bz.device or bx.dtype != bz.dtype or bx.shape != bz.shape:
        raise ValueError("pl_posterior: bx must match bz in device, dtype "
                         "and shape")
    if not (bz.is_contiguous() and bx.is_contiguous()):
        raise ValueError("pl_posterior: bz and bx must be contiguous")
    if not 1 <= len(specs) <= MAX_REGIONS:
        raise ValueError(f"pl_posterior: need 1 to {MAX_REGIONS} regions")
    az = _precision(az, bz, "az")
    ax = _precision(ax, bz, "ax")
    if _lib is None:
        build()
    outs = tuple(torch.empty_like(bz) for _ in range(5))
    fn = (_lib.pl_posterior_f32 if bz.dtype == torch.float32
          else _lib.pl_posterior_f64)
    flat = [float(v) for spec in specs for v in spec]
    c_specs = (ctypes.c_double * len(flat))(*flat)
    err = fn(az.data_ptr(), 0 if az.numel() == 1 else 1, bz.data_ptr(),
             ax.data_ptr(), 0 if ax.numel() == 1 else 1, bx.data_ptr(),
             *[o.data_ptr() for o in outs], bz.numel(), c_specs, len(specs),
             torch.cuda.current_stream(bz.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"pl_posterior kernel launch failed: CUDA error "
                           f"{err}")
    pl_posterior.launches += 1
    return outs


pl_posterior.launches = 0
