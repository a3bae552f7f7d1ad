"""The command line every gallery script shares: ``--big`` (where the JAX
script has it), ``--device``, ``--out``; the output directory and the
seeded generators."""
import argparse
import os

import torch

from .. import config

#: the root of the checkout (the directory that holds tramp_tpu_torch/)
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def parser(doc, big=None, plot=False):
    """An ArgumentParser with ``--device`` and ``--out``; ``big``: the help
    text of ``--big`` (None: the script has no ``--big``); ``plot``: add
    ``--plot``."""
    p = argparse.ArgumentParser(description=doc.strip().splitlines()[0])
    if big is not None:
        p.add_argument("--big", action="store_true", help=big)
    p.add_argument("--device", default=None,
                   help="'cpu' or a CUDA device (default: the first card)")
    p.add_argument("--out", default=None,
                   help="output directory (default: "
                        "build/examples_torch/<group>/ in the checkout)")
    if plot:
        p.add_argument("--plot", action="store_true",
                       help="also draw a figure (needs matplotlib)")
    return p


def device(args):
    """The device the script runs on: ``--device``, else the first card
    (``config.default_device()`` raises where there is none)."""
    if args.device:
        return torch.device(args.device)
    return config.default_device()


def out_dir(args, group):
    "The output directory, made if absent."
    path = args.out or os.path.join(ROOT, "build", "examples_torch", group)
    os.makedirs(path, exist_ok=True)
    return path


def generator(device, seed):
    """A ``torch.Generator`` on ``device`` seeded with ``seed``: the port's
    counterpart of the JAX script's ``jax.random.PRNGKey(seed)``."""
    return torch.Generator(device=device).manual_seed(int(seed))


def mean(x):
    "The mean of a tensor or array as a Python float (float64 sums)."
    return float(torch.as_tensor(x).double().mean())
