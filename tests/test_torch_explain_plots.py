"""The introspection and plotting tools of tramp_tpu_torch against
tramp_tpu, float64 on the CPU: the counterparts of
tests/test_models_misc.py:120-190 (the explain engines, the LaTeX display,
``Model.plot``, ``qplot``), held line by line against the JAX package's
output for the same model; ``math()`` on every class whose JAX counterpart
has one; the four functions of ``experiments.plots`` through matplotlib's
Agg backend (their drawn data against the JAX package's); and the names
the port's ``__init__``s re-export.

Tolerance: printed and LaTeX lines equal as text; drawn data equal (both
packages plot the same numpy arrays).
"""
import contextlib
import importlib
import inspect
import io
import pkgutil

import jax.numpy as jnp
import matplotlib
import numpy as np
import pandas as pd
import pytest
import torch

import tramp_tpu
import tramp_tpu as jt
from tramp_tpu import algos as jalgos
from tramp_tpu import channels as jchannels
from tramp_tpu import experiments as jexperiments
from tramp_tpu.priors import GaussBernoulliPrior as JGaussBernoulliPrior

import tramp_tpu_torch
from tramp_tpu_torch import algos, experiments

from torch_parity import glm_scenario, port_model

matplotlib.use("Agg")


def _relu_net(N=16, M=12, seed=0):
    rng = np.random.RandomState(seed)
    W = rng.randn(M, N) / np.sqrt(N)
    y = np.maximum(W @ rng.randn(N), 0.0) + 0.1 * rng.randn(M)
    dag = (JGaussBernoulliPrior(size=N, rho=0.5) @ jt.V(id="x")
           @ jchannels.LinearChannel(jnp.asarray(W), name="W")
           @ jt.V(id="z") @ jchannels.ReluChannel() @ jt.V(id="a")
           @ jchannels.GaussianChannel(var=1e-2) @ jt.O(id="y"))
    return dag.to_model().to_observed({"y": jnp.asarray(y)})


def _students(kind):
    "(JAX student, port student): tests/test_models_misc.py:108-117's GLM."
    if kind == "glm":
        j_student = glm_scenario(N=30, alpha=0.8, prior_rho=0.5, key=0,
                                 seed=0).student
    else:
        j_student = _relu_net()
    return j_student, port_model(j_student)


def _printed(engine_cls, model, **kw):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        engine = engine_cls(model).iterate(**kw)
    return out.getvalue().splitlines(), engine


@pytest.mark.parametrize("kind", ["glm", "relu_net"])
@pytest.mark.parametrize("engine", ["ExplainMessagePassing",
                                    "ExplainStateEvolution",
                                    "DisplayLatexMessagePassing"])
def test_explain_engines_print_the_jax_lines(engine, kind):
    j_student, student = _students(kind)
    sweeps = 2 if engine != "DisplayLatexMessagePassing" else 1
    lines, explained = _printed(getattr(algos, engine), student,
                                max_iter=sweeps)
    j_lines, _ = _printed(getattr(jalgos, engine), j_student,
                          max_iter=sweeps)
    assert lines == j_lines
    assert len(lines) > 4
    if engine == "DisplayLatexMessagePassing":
        assert explained.latex["forward"] and all(
            line.startswith("$") for line in lines)
    else:
        assert lines.count("FORWARD+BACKWARD PASS") == sweeps
        assert any("x" in line for line in lines)


def _classes_with_math(package):
    "{(module path, class name): class} of classes defining math()."
    out = {}
    for info in pkgutil.walk_packages(package.__path__,
                                      package.__name__ + "."):
        module = importlib.import_module(info.name)
        for name, cls in inspect.getmembers(module, inspect.isclass):
            if cls.__module__ == module.__name__ and "math" in cls.__dict__:
                rel = module.__name__.split(".", 1)[1]
                out[rel, name] = cls
    return out


def test_math_on_every_class_whose_jax_counterpart_has_one():
    j_classes = _classes_with_math(tramp_tpu)
    classes = _classes_with_math(tramp_tpu_torch)
    assert len(j_classes) >= 40
    assert set(j_classes) <= set(classes), set(j_classes) - set(classes)
    for key, j_cls in j_classes.items():
        # an instance of a stand-in type of the same name: the default
        # Factor.math reads the type's name, the others a name or an id
        stand_in = type(key[1], (), {"name": "W", "id": "x"})()
        assert classes[key].math(stand_in) == j_cls.math(stand_in), key
    j_student, student = _students("relu_net")
    assert [n.math() for n in student.nodes] == [
        n.math() for n in j_student.nodes]


def _drawn(ax):
    return [np.asarray(line.get_xydata()) for line in ax.lines]


def test_model_plot():
    "tests/test_models_misc.py:176-184, the same layout as JAX's."
    import matplotlib.pyplot as plt
    j_student, student = _students("glm")
    ax, j_ax = student.plot(), j_student.plot()
    assert len(ax.patches) == len(j_ax.patches) == len(student.nodes)
    assert [t.get_text() for t in ax.texts] == [
        t.get_text() for t in j_ax.texts]
    assert [t.xy for t in ax.texts] == [t.xy for t in j_ax.texts]
    dag_ax = student.model_dag.plot()
    assert len(dag_ax.patches) == len(student.nodes)
    plt.close("all")


def test_qplot_and_the_plot_functions():
    "tests/test_models_misc.py:187-196, and each function's drawn data."
    import matplotlib.pyplot as plt
    df = pd.DataFrame([
        dict(alpha=a, v=1.0 / (1 + a), mse=0.5 / (1 + a), source=s)
        for a in (0.1, 0.2, 0.5, 1.0) for s in ("SE", "EP")])
    for kw in (dict(y="v", color="source"),
               dict(y=["v", "mse"], y_markers=["-", "--"], column="source",
                    xlog=True)):
        fig = experiments.qplot(df, x="alpha", **kw)
        j_fig = jexperiments.qplot(df, x="alpha", **kw)
        for ax, j_ax in zip(fig.axes, j_fig.axes):
            for got, want in zip(_drawn(ax), _drawn(j_ax)):
                np.testing.assert_array_equal(got, want)
        plt.close("all")
    x = torch.linspace(-1, 1, 8, dtype=torch.float64)
    packed = torch.stack([x, x.flip(0)])
    for name, args in (("plot_function", (np.tanh,)),
                       ("plot_compare", (x, 2 * x)),
                       ("plot_compare_complex", (packed, 2 * packed))):
        _, ax = plt.subplots()
        _, j_ax = plt.subplots()
        getattr(experiments, name)(*args, ax=ax)
        j_args = tuple(np.asarray(a) if isinstance(a, torch.Tensor) else a
                       for a in args)
        getattr(jexperiments, name)(*j_args, ax=j_ax)
        for got, want in zip(_drawn(ax), _drawn(j_ax)):
            np.testing.assert_array_equal(got, want)
        offsets = [c.get_offsets() for c in ax.collections]
        j_offsets = [c.get_offsets() for c in j_ax.collections]
        assert len(offsets) == len(j_offsets)
        for got, want in zip(offsets, j_offsets):
            np.testing.assert_array_equal(got, want)
        plt.close("all")


@pytest.mark.parametrize("package", ["algos", "models", "utils",
                                     "experiments", "checks", "parallel"])
def test_the_jax_names_are_re_exported(package):
    """Every public name of the JAX package's subpackage, the mesh and
    ``solve_batch_shard_map`` of ``parallel`` included, and ``stack_pytrees``
    (the JAX name of ``stack_models``)."""
    j_mod = importlib.import_module(f"tramp_tpu.{package}")
    mod = importlib.import_module(f"tramp_tpu_torch.{package}")
    names = getattr(j_mod, "__all__", None) or [
        n for n in dir(j_mod) if not n.startswith("_")]
    missing = [n for n in names if not hasattr(mod, n)]
    assert not missing, missing
