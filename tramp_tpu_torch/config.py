"""Constants, the device/dtype policy and the switches of tramp_tpu_torch.
Counterpart of tramp_tpu/config.py.

Four switches follow the JAX package's names and resolution rules; each is
None (automatic), True or False, and is read through its resolver:

- ``MATVEC_BF16`` (``matvec_bf16()``): the dense products of
  ``LinearChannel._mm`` round both operands to bfloat16 and accumulate in
  float32, giving a float32 result whatever the input dtype. None resolves
  to False here (the JAX package turns it on by itself only on a TPU). Read
  at every product.
- ``STATE_BF16`` (``state_bf16()``): the engine stores float32 ``b``
  messages as bfloat16 and upcasts them at every read, so all arithmetic
  stays float32 and only the stored state is rounded. None resolves to
  False. Read at every store, so ``parallel``'s gated solves set it around
  each of their two phases.
- ``PIN_CONSTANT_MESSAGES`` (``pin_constant_messages()``): the messages of
  factors that are model constants (a Gaussian likelihood's, a Gaussian
  prior's) and the variable cavities that only sum them are written once per
  run instead of being swept and damped. None resolves to False. Read when
  an engine is built.
- ``SPECTRAL_CARRY`` (``spectral_carry()``): the EP engine carries each dense
  ``LinearChannel``'s image U^T bx across sweeps. None resolves to True.
  Read when an engine is built.

One switch is the port's own, resolved the same way:

- ``TRACE`` (``trace()``): when ``trace.span`` records the port's spans.
  None records while a ``torch.profiler`` records, on the host's clock
  alone; True records always and opens a ``record_function`` range per
  span; False never records. Read at every span.

The JAX package's Pallas gate and FFT mode have no counterpart: the port
launches its kernels on the card without a gate and uses ``torch.fft``.
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

#: Default number of Gauss-Hermite nodes (utils/integration.py's measures).
GH_NODES = 127

#: Default number of Gauss-Legendre nodes for truncated-interval measures.
GL_NODES = 65

#: bfloat16 operands with float32 accumulation in ``LinearChannel._mm``.
MATVEC_BF16 = None


def matvec_bf16():
    "Resolve MATVEC_BF16 (None: False)."
    return bool(MATVEC_BF16)


#: bfloat16 storage of the engine's float32 ``b`` messages.
STATE_BF16 = None


def state_bf16():
    "Resolve STATE_BF16 (None: False)."
    return bool(STATE_BF16)


#: Pinned model-constant messages in the EP engine.
PIN_CONSTANT_MESSAGES = None


def pin_constant_messages():
    "Resolve PIN_CONSTANT_MESSAGES (None: False)."
    return bool(PIN_CONSTANT_MESSAGES)


#: The EP engine's spectral-image carry.
SPECTRAL_CARRY = None


def spectral_carry():
    "Resolve SPECTRAL_CARRY (None: True)."
    return True if SPECTRAL_CARRY is None else bool(SPECTRAL_CARRY)


#: When the port's spans record (``trace.span``).
TRACE = None


def trace():
    "Resolve TRACE (None: while a torch.profiler records)."
    if TRACE is None:
        return torch.autograd._profiler_enabled()
    return bool(TRACE)


def default_dtype():
    "The floating dtype of tensors the port creates unless told otherwise."
    return DEFAULT_DTYPE


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
