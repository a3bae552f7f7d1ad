"""Message initializers. Counterpart of
tramp_tpu/algos/initial_conditions.py (ConstantInit)."""
import torch


class ConstantInit:
    "Every message starts at (a, b). Reference initial_conditions.py:13-43."

    def __init__(self, a=0, b=0):
        self.a = a
        self.b = b

    def init(self, message_key, shape, id, direction, device, dtype):
        if message_key == "a":
            return torch.tensor(float(self.a), device=device, dtype=dtype)
        if shape is None:
            raise ValueError(f"no shape known for variable {id}")
        return self.b * torch.ones(shape, device=device, dtype=dtype)
