"""What the hand-written kernels' modules share: where the CUDA sources are
and the libraries go, nvcc's command line, the build of a library with a
plain C interface, ptxas's report, the current stream's handle and the
refusal of bfloat16 inputs.

Importing this module needs neither nvcc nor a GPU.
"""
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

import torch

from .. import trace

_PACKAGE = Path(__file__).resolve().parents[1]
CSRC = _PACKAGE / "csrc"
#: one shared library per source (and floating type, for ``pl_fused``),
#: named by the content of its sources and flags
BUILD_DIR = _PACKAGE.parent / "build" / "tramp_tpu_torch"


def _nvcc():
    from torch.utils.cpp_extension import CUDA_HOME
    nvcc = shutil.which("nvcc") or (
        CUDA_HOME and os.path.join(CUDA_HOME, "bin", "nvcc"))
    if not nvcc or not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed "
                           "to build tramp_tpu_torch's kernels")
    return nvcc


def nvcc_command(source, out, *flags):
    "nvcc's command line that builds ``source`` into the library ``out``."
    return [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
            "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", *flags,
            "-o", str(out), str(source)]


def build_library(source, stem, flags):
    """Compile ``source`` with nvcc for sm_90a into one shared library,
    ``lib<stem>_<tag>.so`` in ``BUILD_DIR``, once per content of the source
    and ``flags``. Returns (its path, nvcc's diagnostics), which hold ptxas's
    register and spill report (``ptxas_report``) and are kept beside the
    library, so that a later build returns them too."""
    tag = hashlib.sha256(source.read_bytes()
                         + " ".join(flags).encode()).hexdigest()[:16]
    lib_path = BUILD_DIR / f"lib{stem}_{tag}.so"
    log_path = BUILD_DIR / f"lib{stem}_{tag}.log"
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
        with trace.span("kernels.compile"):
            proc = subprocess.run(nvcc_command(source, tmp, *flags),
                                  capture_output=True, text=True,
                                  check=False)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed with code {proc.returncode} on "
                               f"{lib_path.name}:\n{log}")
        log_path.write_text(log)
        os.replace(tmp, lib_path)
    return lib_path, log_path.read_text() if log_path.exists() else ""


def _kernel(mangled):
    """(name, what follows it) of the kernel in a mangled symbol: the
    last of its length-prefixed names that ends in ``_kernel``. A length
    may follow a name that ends in digits (an anonymous namespace's hash),
    so every run of digits up to a letter is read from each of its
    digits."""
    found = None
    for m in re.finditer(r"(?=(\d+)[A-Za-z_])", mangled):
        start = m.start() + len(m.group(1))
        end = start + int(m.group(1))
        if mangled[start:end].endswith("_kernel"):
            found = mangled[start:end], mangled[end:]
    return found


def ptxas_report(log):
    """ptxas's ``-v`` report as a list of dicts, one per compiled kernel
    (an entry function whose name ends in ``_kernel``): ``kernel`` (its
    name), ``dtype`` ("f" or "d", None without a type argument), ``params``
    (its integer template arguments; for ``pl_fused``'s the region count K,
    for the message kernel the side, and 1 for the instantiation that takes
    lanes, 0 for the one that takes a single instance; for ``gb_prior``'s
    the elements a load takes), ``registers`` and ``spill_bytes``
    (stores)."""
    out = []
    for chunk in log.split("Compiling entry function '")[1:]:
        kernel = _kernel(chunk.split("'", 1)[0])
        regs = re.search(r"Used (\d+) registers", chunk)
        spill = re.search(r"(\d+) bytes spill stores", chunk)
        if not (kernel and regs):
            continue
        name, rest = kernel
        args = re.match(r"I([fd])((?:L[ib]\d+E)*)E", rest)
        out.append({
            "kernel": name, "dtype": args and args.group(1),
            "params": [int(v) for v in re.findall(r"L[ib](\d+)E",
                                                  args.group(2))]
            if args else [],
            "registers": int(regs.group(1)),
            "spill_bytes": int(spill.group(1)) if spill else 0})
    return out


def refuse_bf16(what, *arrays):
    """Raise where an input is bfloat16: the kernels and their plain
    versions take float32 or float64, and a wrapper never converts."""
    if any(isinstance(a, torch.Tensor) and a.dtype == torch.bfloat16
           for a in arrays):
        raise ValueError(f"{what}: a bfloat16 input; the kernels and their "
                         "plain versions take float32 or float64")


def stream(device):
    "The current stream's handle, without building a Stream object."
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is None:
        return torch.cuda.current_stream(device).cuda_stream
    return raw(device.index)
