"""Message initializers. Counterpart of
tramp_tpu/algos/initial_conditions.py. ``init`` also takes the device and
dtype of the state it fills."""
import numpy as np
import torch


class InitialConditions:
    def init(self, message_key, shape, id, direction, device, dtype):
        if message_key == "a":
            value = self.init_a(shape, id, direction)
        elif message_key == "b":
            if shape is None:
                raise ValueError(f"no shape known for variable {id}")
            value = self.init_b(shape, id, direction)
        else:
            raise ValueError(f"unknown message key {message_key}")
        return torch.as_tensor(value, device=device, dtype=dtype)

    def __repr__(self):
        args = ", ".join(f"{k}={v!r}" for k, v in self.__dict__.items())
        return f"{type(self).__name__}({args})"


class ConstantInit(InitialConditions):
    "Every message starts at (a, b). Reference initial_conditions.py:13-43."

    def __init__(self, a=0, b=0):
        self.a = a
        self.b = b

    def init_a(self, shape, id, direction):
        return float(self.a)

    def init_b(self, shape, id, direction):
        return self.b * np.ones(shape)


class NoisyInit(InitialConditions):
    """Gaussian initial messages from ``numpy.random.RandomState(seed)``,
    drawn in the order of the engine's slots, as the JAX package draws
    them."""

    def __init__(self, a_mean=0, a_var=0, b_mean=0, b_var=1, seed=0):
        self.a_mean = a_mean
        self.a_var = a_var
        self.b_mean = b_mean
        self.b_var = b_var
        self.rng = np.random.RandomState(seed)

    def init_a(self, shape, id, direction):
        return self.a_mean + np.sqrt(self.a_var) * self.rng.standard_normal()

    def init_b(self, shape, id, direction):
        return (self.b_mean
                + np.sqrt(self.b_var) * self.rng.standard_normal(shape))


class CustomInit(InitialConditions):
    """Custom init on selected variables.

    - a_init / b_init: lists of (variable.id, direction, value) tuples;
      edges adjacent to `variable.id` with the given message direction get
      that initial value. Reference initial_conditions.py:45-86."""

    def __init__(self, a_init=None, b_init=None, a=0, b=0):
        a_init = a_init or []
        self.a_init = {(id, direction): a for id, direction, a in a_init}
        b_init = b_init or []
        self.b_init = {(id, direction): b for id, direction, b in b_init}
        self.a = a
        self.b = b

    def init_a(self, shape, id, direction):
        return float(self.a_init.get((id, direction), self.a))

    def init_b(self, shape, id, direction):
        b = self.b_init.get((id, direction))
        if b is None:
            return self.b * np.ones(shape)
        if tuple(b.shape) != tuple(shape):
            raise ValueError(f"b_init of {id} {direction} has shape "
                             f"{tuple(b.shape)}, the variable {tuple(shape)}")
        return b
