"""Small array helpers. Counterpart of tramp_tpu/utils/misc.py.

A complex array is packed as a real one with a leading axis of length 2
(real part, imaginary part), the layout of the modulus likelihood and the
complex channels; with lanes the packed axis comes after the lane axis
(axis 1). The complex channels keep their operators as complex tensors and
multiply a packed message through ``pair_matmul``, the counterpart of
tramp_tpu/ops/dft.py ``pair_matmul`` on torch's complex dtypes."""
import torch


def pack(c, axis=0):
    "A complex ``c`` packed with its re/im axis at ``axis``."
    return torch.stack([c.real, c.imag], dim=axis)


def unpack(z, axis=0):
    "The complex tensor of a packed ``z`` whose re/im axis is ``axis``."
    return torch.complex(z.select(axis, 0), z.select(axis, 1))


def complex2array(z):
    """Pack complex z into a real array Z with Z[0]=Re z, Z[1]=Im z.
    Reference tramp/utils/misc.py:13-19."""
    return pack(z)


def array2complex(Z):
    """Unpack real array Z (leading axis of length 2) into complex z.
    Reference tramp/utils/misc.py:22-27."""
    if Z.shape[0] != 2:
        raise ValueError("First axis of Z must be of length 2")
    return unpack(Z)


def pair_matmul(A, z, adjoint=False, axis=0):
    """``A @ z`` (``A^H @ z`` with ``adjoint``) for a complex matrix ``A``
    and a packed operand ``z``: one instance ``(2, m, ...)`` (axis 0), or
    lanes ``(B, 2, m)`` (axis 1) under one shared ``A`` (n, m) or one per
    lane ``(B, n, m)``. Returns the packed product."""
    c = unpack(z, axis)
    if A.ndim == 3:
        M = A.conj().transpose(1, 2) if adjoint else A
        out = torch.bmm(M, c.unsqueeze(-1)).squeeze(-1)
    elif axis == 1:
        # (A^H c)^T = c^T conj(A), (A c)^T = c^T A^T
        out = c @ (A.conj() if adjoint else A.T)
    else:
        out = (A.conj().T if adjoint else A) @ c
    return pack(out, axis)


def relu(x):
    return torch.clamp(x, min=0.0)


def leaky_relu(x, slope):
    return torch.where(x < 0, slope * x, x)


def hard_tanh(x):
    return torch.clamp(x, -1.0, 1.0)


def hard_sigm(x):
    return torch.clamp(0.5 + x / 6.0, 0.0, 1.0)


def symm_door(x, width):
    return torch.where(torch.abs(x) < width, -1.0, 1.0)
