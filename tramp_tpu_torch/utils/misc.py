"""Small array helpers. Counterpart of tramp_tpu/utils/misc.py.

A complex array is packed as a real one with a leading axis of length 2
(real part, imaginary part), the layout of the modulus likelihood."""
import torch


def complex2array(z):
    """Pack complex z into a real array Z with Z[0]=Re z, Z[1]=Im z.
    Reference tramp/utils/misc.py:13-19."""
    return torch.stack([z.real, z.imag], dim=0)


def array2complex(Z):
    """Unpack real array Z (leading axis of length 2) into complex z.
    Reference tramp/utils/misc.py:22-27."""
    if Z.shape[0] != 2:
        raise ValueError("First axis of Z must be of length 2")
    return torch.complex(Z[0], Z[1])


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
