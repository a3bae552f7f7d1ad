"""Constants and the device/dtype policy of tramp_tpu_torch.

Counterpart of tramp_tpu/config.py:10-16. The TPU switches of the JAX
package (bf16 matvecs and state, pinned messages, the Pallas gate, the FFT
mode) have no counterpart here; the spectral-image carry is the engine's
only behaviour.
"""
import numpy as np
import torch

#: Precision clipping bounds for message precisions (reference
#: tramp/base.py:238-239).
AMIN = 1e-11
AMAX = 1e11

#: Floor for the numerically safe inverse (reference tramp/base.py:44-46).
VMIN = 1e-20

#: Default floating dtype of tensors the port creates.
DEFAULT_DTYPE = torch.float32


def default_device():
    """The first CUDA device. The port runs on the card unless the caller
    names another device, so a machine without one raises here instead of
    carrying on on the CPU unnoticed."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' to run on the CPU")
    return torch.device("cuda", 0)


def as_tensor(x, device=None, dtype=None):
    """``x`` as a floating tensor on ``device`` with ``dtype``.

    A tensor keeps its own device and floating dtype where the argument is
    None; anything else (numpy arrays, Python numbers) goes to ``device``
    (None: ``default_device()``, which needs a card) with the default
    dtype."""
    if isinstance(x, torch.Tensor):
        if dtype is None and not x.is_floating_point():
            dtype = DEFAULT_DTYPE
        return x.to(device=device or x.device, dtype=dtype or x.dtype)
    return torch.as_tensor(x, device=device or default_device(),
                           dtype=dtype or DEFAULT_DTYPE)


def as_complex(x, device=None, dtype=None):
    """``x`` (complex or real) as a complex tensor on ``device`` whose real
    and imaginary parts have the floating ``dtype``.

    A tensor keeps its own device and precision where the argument is None;
    anything else (numpy arrays) goes to ``device`` (None:
    ``default_device()``) with the default dtype."""
    if isinstance(x, torch.Tensor):
        real = x.real.dtype if x.is_complex() else x.dtype
        if dtype is None and not real.is_floating_point:
            dtype = DEFAULT_DTYPE
        device = device or x.device
        dtype = dtype or real
    else:
        x = torch.as_tensor(np.asarray(x))
        device = device or default_device()
        dtype = dtype or DEFAULT_DTYPE
    return x.to(device=device, dtype=dtype.to_complex())
