"""FFT-ready convolution filters (numpy). Counterpart of
tramp_tpu/utils/conv_filters.py, kept as a copy: the port imports nothing
of the JAX package. Reference tramp/utils/conv_filters.py."""
import numpy as np


def first_derivative_filter(N):
    "Forward first derivative filter. Reference l:31-36."
    f = np.zeros(N)
    f[0] = -1
    f[1] = 1
    return f


def second_derivative_filter(N):
    f = np.zeros(N)
    f[0] = -2
    f[1] = f[-1] = 1
    return f


def gaussian_filter(sigma, N):
    "Scaled gaussian blur filter. Reference l:47-54."
    freq = np.fft.fftfreq(N)
    coef = 2 * (np.pi * sigma) ** 2
    y = np.fft.ifft(np.exp(-coef * freq**2))
    return np.real(y)


def first_derivative_along_axis(axis, shape):
    f = np.zeros(shape)
    swaped = np.swapaxes(f, -1, axis)
    d = len(shape)
    zero = (0,) * (d - 1)
    swaped[zero] = first_derivative_filter(swaped.shape[-1])
    return np.swapaxes(swaped, -1, axis)


def second_derivative_along_axis(axis, shape):
    f = np.zeros(shape)
    swaped = np.swapaxes(f, -1, axis)
    d = len(shape)
    zero = (0,) * (d - 1)
    swaped[zero] = second_derivative_filter(swaped.shape[-1])
    return np.swapaxes(swaped, -1, axis)


def differential_filter(shape, D1, D2=None):
    "Filter D = D1 . dx + D2 . dx dx. Reference l:85-95."
    d = len(shape)
    D2 = D2 if D2 is not None else np.zeros(d)
    return sum(
        D1[axis] * first_derivative_along_axis(axis, shape)
        for axis in range(d)
    ) + sum(
        D2[axis] * second_derivative_along_axis(axis, shape)
        for axis in range(d)
    )


def laplacian_filter(shape):
    d = len(shape)
    return sum(
        second_derivative_along_axis(axis, shape) for axis in range(d))


def gradient_filters(shape):
    "gradient[i] = derivative filter along direction i. Reference l:102-119."
    d = len(shape)
    gradient = np.zeros((d,) + shape)
    for axis in range(d):
        gradient[axis] = first_derivative_along_axis(axis, shape)
    return gradient
