"""The one generator of the benchmark's inputs: every tensor the program
receives is drawn here, on the device, from ``--seed`` through an explicit
``torch.Generator``.

The draws are those of chip_smoke.py's ``relu_net`` and
``batch_of_observations`` (copied, not imported): an i.i.d. Gaussian
operator W of N(0, 1/N) entries and, per lane, a teacher
x ~ (1 - rho) delta + rho N(0, 1), y = [relu](W x) + N(0, noise_var).
Each stream has a seed of its own, derived from ``--seed`` and the
stream's path (``OPERATOR``, ``CALL`` and the call's index, ...), so the
same seed gives the same inputs and no two streams share their numbers.
"""
import numpy as np
import torch

OPERATOR, CALL, STUDENT, WARM_UP, SAMPLE = range(5)

_DTYPES = {"float32": torch.float32, "float64": torch.float64}


def dtype(config):
    return _DTYPES[config["dtype"]]


def stream_seed(seed, *path):
    """A 63-bit seed for the stream ``path`` of the run seeded ``seed``
    (any whole number, also past 32 bits)."""
    entropy = [int(seed) % 2**64] + [int(p) for p in path]
    state = np.random.SeedSequence(entropy).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def generator(device, seed, *path):
    return torch.Generator(device=device).manual_seed(
        stream_seed(seed, *path))


def operator(config, seed, device):
    "W of shape (M, N), N(0, 1/N) entries, in the configuration's dtype."
    M, N = config["M"], config["N"]
    g = generator(device, seed, OPERATOR)
    return torch.randn((M, N), generator=g, device=device,
                       dtype=dtype(config)) / np.sqrt(N)


def observations(config, W, g, lanes):
    """``lanes`` observations y (lanes, M) of teachers drawn from the
    prior, through W and the configuration's output ("linear" or "relu"),
    with Gaussian noise."""
    kw = dict(generator=g, device=W.device, dtype=W.dtype)
    M, N = W.shape
    x = (torch.randn((lanes, N), **kw)
         * (torch.rand((lanes, N), **kw) < config["rho"]))
    z = x @ W.T
    if config["output"] == "relu":
        z = torch.relu(z)
    elif config["output"] != "linear":
        raise ValueError(f"unknown output {config['output']!r}")
    return z + np.sqrt(config["noise_var"]) * torch.randn((lanes, M), **kw)
