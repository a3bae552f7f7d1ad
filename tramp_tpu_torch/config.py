"""Constants and the device/dtype policy of tramp_tpu_torch.

Counterpart of tramp_tpu/config.py:10-16. The TPU switches of the JAX
package (bf16 matvecs and state, pinned messages, the Pallas gate, the FFT
mode) have no counterpart here; the spectral-image carry is the engine's
only behaviour.
"""
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
    "The first CUDA device when one is present, else the CPU."
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def as_tensor(x, device=None, dtype=None):
    """``x`` as a floating tensor on ``device`` with ``dtype``.

    A tensor keeps its own device and floating dtype where the argument is
    None; anything else (numpy arrays, Python numbers) goes to the default
    device and dtype."""
    if isinstance(x, torch.Tensor):
        if dtype is None and not x.is_floating_point():
            dtype = DEFAULT_DTYPE
        return x.to(device=device or x.device, dtype=dtype or x.dtype)
    return torch.as_tensor(x, device=device or default_device(),
                           dtype=dtype or DEFAULT_DTYPE)
