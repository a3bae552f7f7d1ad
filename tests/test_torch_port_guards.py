"""Guards of the port's boundaries: tramp_tpu_torch imports neither JAX nor
the JAX package; the piecewise-linear wrappers take their plain versions
for CPU tensors and a shape rule for meta tensors, and convert each
channel's regions once; their module imports without nvcc or a GPU (the
kernels are built at first launch); a model built without a device needs a
card, and one built with ``device="cpu"`` does not (the priors and
likelihoods of Queue 1 item 3 too, whose registries keep no waiting
types, and the complex channels, shape channels and composite models of
items 4a and 4b, the structured channels, TV builders and low-rank state
evolution of items 4c and 6); the state-evolution entry points keep the same rule, take the
plain twin for their integrands on the CPU, and import no pandas until a
DataFrame is asked for; and, on a card, the kernels agree with their plain
versions.

This file imports no JAX, so the card-only test runs on a machine without
it: ``python -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_port_guards.py``.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tramp_tpu_torch.channels import (
    SgnChannel, AbsChannel, ReluChannel, LeakyReluChannel, HardTanhChannel,
    HardSigmoidChannel, SymmetricDoorChannel,
)
from tramp_tpu_torch.ops import pl_fused

REPO = Path(__file__).resolve().parents[1]
CHANNELS = [
    SgnChannel(), AbsChannel(), ReluChannel(), LeakyReluChannel(slope=0.3),
    HardTanhChannel(), SymmetricDoorChannel(width=0.7),
]


def _run(code, env=None):
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)


def test_port_imports_no_jax():
    code = ("import sys, tramp_tpu_torch, tramp_tpu_torch.convert; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib')) or m == 'tramp_tpu' or "
            "m.startswith('tramp_tpu.')]; "
            "assert not bad, bad")
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr


def test_port_sources_import_no_jax():
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|jaxlib|tramp_tpu|__graft_entry__)"
        r"(\.|\s|$)", re.M)
    sources = sorted((REPO / "tramp_tpu_torch").rglob("*.py"))
    sources += [REPO / "chip_smoke.py", REPO / "chip_kernel_times.py",
                REPO / "chip_stop_floor.py"]
    assert any(p.parent.name == "parallel" for p in sources)
    offenders = [str(p) for p in sources if pattern.search(p.read_text())]
    assert len(sources) > 10 and not offenders, offenders


def test_tooling_modules_import_no_jax_pandas_or_matplotlib():
    """The engine extras and the tooling (checks, explain, plots, layout,
    checkpoints) import neither JAX nor the JAX package, and leave pandas
    and matplotlib to the functions that draw or return a DataFrame."""
    code = (
        "import sys\n"
        "import tramp_tpu_torch.checks, tramp_tpu_torch.algos.explain\n"
        "import tramp_tpu_torch.experiments.plots\n"
        "import tramp_tpu_torch.models.dag_layout\n"
        "import tramp_tpu_torch.parallel.checkpoint\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'tramp_tpu', 'pandas', 'matplotlib')]\n"
        "assert not bad, bad\n")
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr


def _inputs(n, dtype, device="cpu", seed=0):
    rng = np.random.RandomState(seed)
    bz = torch.as_tensor(2 * rng.randn(n), dtype=dtype, device=device)
    bx = torch.as_tensor(2 * rng.randn(n), dtype=dtype, device=device)
    az = torch.tensor(1.7, dtype=dtype, device=device)
    ax = torch.tensor(0.9, dtype=dtype, device=device)
    return az, bz, ax, bx


def test_wrapper_uses_plain_version_on_cpu():
    az, bz, ax, bx = _inputs(257, torch.float64)
    before = pl_fused.pl_posterior.launches
    for channel in CHANNELS:
        got = pl_fused.pl_posterior(az, bz, ax, bx, channel.region_specs)
        want = pl_fused.pl_posterior_plain(az, bz, ax, bx,
                                           channel.region_specs)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert pl_fused.pl_posterior.launches == before


def test_wrapper_shape_rule_on_meta():
    az, bz, ax, bx = (t.to("meta") for t in _inputs(300, torch.float32))
    outs = pl_fused.pl_posterior(az, bz, ax, bx, ReluChannel().region_specs)
    assert len(outs) == 5
    assert all(o.device.type == "meta" and o.shape == bz.shape
               and o.dtype == torch.float32 for o in outs)


MESSAGES = [
    (pl_fused.pl_forward_message, pl_fused.pl_forward_message_plain),
    (pl_fused.pl_backward_message, pl_fused.pl_backward_message_plain),
]


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("wrapper", [pl_fused.pl_posterior]
                         + [fused for fused, _ in MESSAGES],
                         ids=["posterior", "forward", "backward"])
def test_wrappers_refuse_bfloat16(wrapper, device):
    """A bfloat16 input raises (the engine upcasts its bfloat16 state
    before any factor reads it; a wrapper never converts one), and counts
    no launch."""
    az, bz, ax, bx = _inputs(64, torch.float32, device=device)
    before = wrapper.launches
    for args in ((az, bz.bfloat16(), ax, bx), (az, bz, ax, bx.bfloat16()),
                 (az.bfloat16(), bz, ax, bx)):
        with pytest.raises(ValueError, match="bfloat16"):
            wrapper(*args, ReluChannel().region_specs)
    assert wrapper.launches == before


@pytest.mark.parametrize("fused,plain", MESSAGES,
                         ids=["forward", "backward"])
def test_message_wrapper_uses_plain_version_on_cpu(fused, plain):
    az, bz, ax, bx = _inputs(257, torch.float64)
    before = fused.launches
    for channel in CHANNELS:
        got = fused(az, bz, ax, bx, channel.region_specs)
        want = plain(az, bz, ax, bx, channel.region_specs)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert fused.launches == before


@pytest.mark.parametrize("per_element", [False, True],
                         ids=["scalar", "per_element"])
@pytest.mark.parametrize("fused,plain", MESSAGES,
                         ids=["forward", "backward"])
def test_message_wrapper_shape_rule_on_meta(fused, plain, per_element):
    "Shapes and dtypes on meta tensors are those of the plain version."
    az, bz, ax, bx = _inputs(300, torch.float32)
    if per_element:
        az, ax = az.expand(300).contiguous(), ax.expand(300).contiguous()
    specs = ReluChannel().region_specs
    want = plain(az, bz, ax, bx, specs)
    got = fused(*(t.to("meta") for t in (az, bz, ax, bx)), specs)
    assert len(got) == 2
    for g, w in zip(got, want):
        assert g.device.type == "meta"
        assert g.shape == w.shape and g.dtype == w.dtype


def _lane_inputs(lanes, n, dtype, device="cpu", seed=0):
    "(az, bz, ax, bx) with lanes: messages (lanes, n), precisions (lanes, 1)."
    rng = np.random.RandomState(seed)
    def t(x):
        return torch.as_tensor(x, dtype=dtype, device=device)
    return (t(1.2 + rng.rand(lanes, 1)), t(2 * rng.randn(lanes, n)),
            t(0.4 + rng.rand(lanes, 1)), t(2 * rng.randn(lanes, n)))


@pytest.mark.parametrize("other", ["per_lane", "scalar", "per_element"])
@pytest.mark.parametrize("fused,plain", MESSAGES,
                         ids=["forward", "backward"])
def test_message_wrapper_shape_rule_on_meta_with_lanes(fused, plain, other):
    """With lanes the meta shapes are the plain version's: a_new one value
    per lane, whatever the other side's precision looks like."""
    az, bz, ax, bx = _lane_inputs(5, 300, torch.float32)
    others = {"per_lane": None, "scalar": torch.tensor(0.9),
              "per_element": torch.rand(5, 300) + 0.4}
    if others[other] is not None:
        if fused is pl_fused.pl_forward_message:
            az = others[other]
        else:
            ax = others[other]
    specs = ReluChannel().region_specs
    want = plain(az, bz, ax, bx, specs)
    got = fused(*(t.to("meta") for t in (az, bz, ax, bx)), specs)
    assert want[0].shape == (5, 1) and want[1].shape == (5, 300)
    for g, w in zip(got, want):
        assert g.device.type == "meta"
        assert g.shape == w.shape and g.dtype == w.dtype
    outs = pl_fused.pl_posterior(
        *(t.to("meta") for t in (az, bz, ax, bx)), specs)
    assert all(o.shape == (5, 300) for o in outs)


def test_precision_strides_tell_scalar_lane_and_element():
    "How the kernels are told to read a precision (element, lane strides)."
    az, bz, ax, bx = _lane_inputs(5, 300, torch.float32)
    assert pl_fused._lanes(az, bz, ax) == 5
    assert pl_fused._lanes(az, bz, torch.tensor(0.9)) == 5
    assert pl_fused._lanes(torch.tensor(1.7), bz, torch.tensor(0.9)) is None
    assert pl_fused._lanes(torch.rand(5, 300), bz, torch.rand(5, 300)) is None
    assert pl_fused._strides(az, bz, 5) == (0, 1)
    assert pl_fused._strides(torch.tensor(0.9), bz, 5) == (0, 0)
    assert pl_fused._strides(torch.rand(5, 300), bz, 5) == (1, 300)
    assert pl_fused._strides(torch.rand(5, 300), bz, None) == (1, 1500)
    assert pl_fused._a_new_shape(ax, bz, 5) == (5, 1)
    assert pl_fused._a_new_shape(torch.tensor(0.9), bz, 5) == (5, 1)
    assert pl_fused._a_new_shape(torch.tensor(0.9), bz, None) == ()
    assert pl_fused._a_new_shape(torch.rand(5, 300), bz, 5) == (5, 300)
    with pytest.raises(ValueError, match="one value per lane"):
        pl_fused._precision(torch.rand(4, 1), bz, "az")


def test_region_specs_are_converted_once_per_channel_and_dtype():
    tanh, sigm = HardTanhChannel(), HardSigmoidChannel()
    f32, f64 = torch.float32, torch.float64
    a = pl_fused._spec_array(tanh.region_specs, f32)
    assert pl_fused._spec_array(HardTanhChannel().region_specs, f32) is a
    b = pl_fused._spec_array(sigm.region_specs, f32)
    c = pl_fused._spec_array(tanh.region_specs, f64)
    assert a is not b and a is not c and a._type_ is not c._type_
    # per region: zmin, zmax, x0, slope, slope^2, x0^2, kind
    assert len(a) == len(b) == 3 * 7
    assert list(a)[:7] == [1.0, np.inf, 1.0, 0.0, 0.0, 1.0, 1.0]
    assert list(b)[7:14] == [-2.5, 2.5, 0.5, np.float32(0.2),
                             np.float32(0.2 * 0.2), 0.25, 3.0]
    assert list(a)[20] == list(b)[20] == 2.0


def test_ptxas_report_reads_registers_and_spills():
    log = (
        "ptxas info    : Compiling entry function '_ZN55_GLOBAL__N__4f1a"
        "19pl_posterior_kernelIfLi2EEEvPKT_lS3_' for 'sm_90a'\n"
        "ptxas info    : Function properties for _ZN55_GLOBAL__N__4f1a\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 48 registers, used 0 barriers\n"
        "ptxas info    : Compiling entry function '_ZN55_GLOBAL__N__9c2b"
        "17pl_message_kernelIdLi3ELi1EEEvPKT_' for 'sm_90a'\n"
        "    16 bytes stack frame, 12 bytes spill stores, 12 bytes spill "
        "loads\n"
        "ptxas info    : Used 128 registers, used 1 barriers\n"
        "ptxas info    : Compiling entry function '_ZN55_GLOBAL__N__9c2b"
        "17pl_message_kernelIfLi2ELi0ELb1EEEvPKT_' for 'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 64 registers, used 1 barriers\n")
    assert pl_fused.ptxas_report(log) == [
        {"kernel": "pl_posterior_kernel", "dtype": "f", "params": [2],
         "registers": 48, "spill_bytes": 0},
        {"kernel": "pl_message_kernel", "dtype": "d", "params": [3, 1],
         "registers": 128, "spill_bytes": 12},
        {"kernel": "pl_message_kernel", "dtype": "f", "params": [2, 0, 1],
         "registers": 64, "spill_bytes": 0}]


NO_CARD = dict(os.environ, CUDA_VISIBLE_DEVICES="")


def test_default_device_raises_without_a_card():
    code = (
        "import numpy as np\n"
        "from tramp_tpu_torch import config\n"
        "from tramp_tpu_torch.channels import LinearChannel\n"
        "for call in (config.default_device,\n"
        "             lambda: config.as_tensor(np.zeros(3)),\n"
        "             lambda: LinearChannel(np.eye(3))):\n"
        "    try:\n"
        "        call()\n"
        "    except RuntimeError as e:\n"
        "        assert \"device='cpu'\" in str(e), e\n"
        "    else:\n"
        "        raise SystemExit('no error without a card')\n")
    proc = _run(code, env=NO_CARD)
    assert proc.returncode == 0, proc.stderr + proc.stdout


def test_explicit_cpu_model_solves_without_a_card():
    code = (
        "import numpy as np, torch\n"
        "import tramp_tpu_torch as tt\n"
        "from tramp_tpu_torch.channels import (\n"
        "    GaussianChannel, LinearChannel, ReluChannel)\n"
        "from tramp_tpu_torch.priors import GaussBernoulliPrior\n"
        "kw = dict(device='cpu', dtype=torch.float64)\n"
        "rng = np.random.RandomState(0)\n"
        "W = rng.randn(16, 32) / np.sqrt(32)\n"
        "teacher = (GaussBernoulliPrior(size=32, rho=0.25, **kw)\n"
        "           @ tt.V(id='x') @ LinearChannel(W, **kw) @ tt.V(id='z')\n"
        "           @ ReluChannel() @ tt.V(id='a')\n"
        "           @ GaussianChannel(var=1e-2) @ tt.O(id='y')).to_model()\n"
        "y = teacher.sample(torch.Generator().manual_seed(0))['y']\n"
        "ep = tt.ExpectationPropagation(teacher.to_observed({'y': y}))\n"
        "ep.iterate(max_iter=20, damping=0.1)\n"
        "r = ep.get_variable_data('x')['r']\n"
        "assert r.device.type == 'cpu' and r.dtype == torch.float64\n"
        "assert bool(torch.isfinite(r).all()) and ep.n_iter > 1\n")
    proc = _run(code, env=NO_CARD)
    assert proc.returncode == 0, proc.stderr + proc.stdout


def test_se_entry_points_need_a_card_or_an_explicit_cpu():
    code = (
        "import torch\n"
        "import tramp_tpu_torch as tt\n"
        "from tramp_tpu_torch import experiments, parallel\n"
        "kw = dict(prior_type='gauss_bernoulli', output_type='gaussian',\n"
        "          output_var=1e-11)\n"
        "model = tt.glm_state_evolution(alpha=0.5, prior_rho=0.25, **kw)\n"
        "grid = dict(grid_kwargs={'alpha': [0.3, 0.6]}, prior_rho=0.25, **kw)\n"
        "line = dict(id='x', a0=0, mse_criterion='perfect', alpha_min=1e-5,\n"
        "            alpha_max=2.0, alpha_tol=0.5, prior_rho=0.25,\n"
        "            model_builder=tt.glm_state_evolution, **kw)\n"
        "calls = {\n"
        "    'StateEvolution': lambda **d: tt.StateEvolution(model, **d),\n"
        "    'SESolver': lambda **d: parallel.SESolver(model, **d),\n"
        "    'grid': lambda **d: parallel.se_phase_grid_records(\n"
        "        tt.glm_state_evolution, **grid, **d),\n"
        "    'critical': lambda **d: experiments.find_critical_alpha(\n"
        "        **line, **d),\n"
        "    'stack': lambda **d: parallel.stack_models(\n"
        "        [model, tt.glm_state_evolution(alpha=0.6, prior_rho=0.25,\n"
        "                                       **kw)], **d)}\n"
        "for name, call in calls.items():\n"
        "    try:\n"
        "        call()\n"
        "    except RuntimeError as e:\n"
        "        assert \"device='cpu'\" in str(e), (name, e)\n"
        "    else:\n"
        "        raise SystemExit(name + ': no error without a card')\n"
        "    call(device='cpu')\n"
        "se = calls['StateEvolution'](device='cpu').iterate(max_iter=50)\n"
        "v = se.get_variable_data('x')['v']\n"
        "assert v.device.type == 'cpu' and v.dtype == torch.float64\n"
        "assert 0 < float(v) < 0.25 and se.n_iter > 2\n")
    proc = _run(code, env=NO_CARD)
    assert proc.returncode == 0, proc.stderr + proc.stdout


def test_port_imports_no_pandas_until_a_dataframe_is_asked_for():
    code = (
        "import sys\n"
        "import tramp_tpu_torch as tt\n"
        "from tramp_tpu_torch import algos, experiments, parallel\n"
        "kw = dict(prior_type='gauss_bernoulli', output_type='gaussian',\n"
        "          output_var=1e-11)\n"
        "records = parallel.se_phase_grid_records(\n"
        "    tt.glm_state_evolution, {'alpha': [0.3, 0.6]}, device='cpu',\n"
        "    prior_rho=0.25, **kw)\n"
        "assert len(records) == 2 and 'pandas' not in sys.modules\n"
        "track = algos.TrackEvolution()\n"
        "tt.StateEvolution(tt.glm_state_evolution(alpha=0.5, **kw),\n"
        "                  device='cpu').iterate(max_iter=3, callback=track)\n"
        "assert len(track.records) == 6 and 'pandas' not in sys.modules\n")
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr + proc.stdout


def test_se_integrands_take_the_plain_twin_on_cpu():
    """The piecewise-linear channel's scalar_* integrands are outputs of the
    five-output posterior: on CPU tensors its plain twin, with no launch
    counted, and no isotropic mean taken (one value per node)."""
    az, bz, ax, bx = _inputs(257, torch.float64)
    before = pl_fused.pl_posterior.launches
    for channel in CHANNELS:
        want = pl_fused.pl_posterior_plain(az, bz, ax, bx,
                                           channel.region_specs)
        for method, stream in (("scalar_backward_variance", 1),
                               ("scalar_forward_variance", 3),
                               ("scalar_log_partition", 4)):
            got = getattr(channel, method)(az, bz, ax, bx)
            assert got.shape == bz.shape and torch.equal(got, want[stream])
    assert pl_fused.pl_posterior.launches == before


def test_se_measure_calls_the_integrand_once_for_all_regions():
    """One call of the integrand per error, whatever the number of regions:
    on a card that is one launch of the five-output kernel, two per sweep."""
    az, ax, tau = (torch.tensor(v, dtype=torch.float64)
                   for v in (1.7, 0.9, 1.2))
    for channel in CHANNELS:
        shapes = []

        def f(bz, bx):
            shapes.append((tuple(bz.shape), tuple(bx.shape),
                           bz.is_contiguous() and bx.is_contiguous()))
            return bz

        channel.beliefs_measure(az, ax, tau, f)
        nodes = len(channel.region_specs) * 100 * 100
        assert shapes == [((nodes,), (nodes,), True)]
        shapes.clear()
        channel.beliefs_measure(az.expand(4, 1), ax.expand(4, 1),
                                tau.expand(4, 1), f)
        assert shapes == [((4, nodes), (4, nodes), True)]


def _jax_registry_keys(path, name):
    """The keys of the dict literal ``name`` in a module of the JAX package,
    read from its source (this file imports no JAX)."""
    import ast
    tree = ast.parse((REPO / path).read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == name for t in node.targets):
            return {k.value for k in node.value.keys}
    raise AssertionError(f"{name} not found in {path}")


def test_no_prior_or_likelihood_type_waits_for_item_3():
    """Queue 1 items 3, 4a, 4b, 4c and 6 and the tanh channel are in: the
    registries of priors, likelihoods, channels and ensembles hold every
    type of the JAX package's and keep no list of waiting types, and no
    module of the port points at item 3, 4c or 6 any more."""
    from tramp_tpu_torch import channels, ensembles, likelihoods, priors
    for module in (priors, likelihoods, channels, ensembles):
        assert not hasattr(module, "_WAITING"), module.__name__
    assert len(priors.PRIOR_CLASSES) == 9
    assert len(likelihoods.LIKELIHOOD_CLASSES) == 10
    assert set(channels.CHANNEL_CLASSES) == _jax_registry_keys(
        "tramp_tpu/channels/__init__.py", "CHANNEL_CLASSES")
    assert set(ensembles.ENSEMBLE_CLASSES) == _jax_registry_keys(
        "tramp_tpu/ensembles/__init__.py", "ENSEMBLE_CLASSES")
    for kind in ("conv", "dft", "rotation", "tanh", "low_rank_gram"):
        assert channels.CHANNEL_CLASSES[kind].__name__ in channels.__all__
    stale = [str(p) for p in sorted((REPO / "tramp_tpu_torch").rglob("*.py"))
             if re.search(r"item (3|4c|6)\b", p.read_text())]
    assert not stale, stale


def _jax_public_names(path):
    """(module-level public names, {public class: its public methods}) of a
    tramp_tpu source file, read with ``ast`` (no JAX import)."""
    import ast
    names, methods = [], {}
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.append(node.name)
            if isinstance(node, ast.ClassDef):
                methods[node.name] = [
                    f.name for f in node.body
                    if isinstance(f, ast.FunctionDef)
                    and not f.name.startswith("_")]
        elif isinstance(node, ast.Assign):
            names += [t.id for t in node.targets if isinstance(t, ast.Name)]
    return [n for n in names if not n.startswith("_")], methods


def _not_to_port():
    """The code ROADMAP.md's "Code not to port" list names: the
    backquoted names and files of that paragraph."""
    text = (REPO / "ROADMAP.md").read_text()
    start = re.search(r"^Code not to port", text, re.M).start()
    section = text[start:text.index("\n###", start)]
    return set(re.findall(r"`([^`]+)`", section))


def test_every_public_name_of_the_jax_package_has_a_counterpart():
    """Every module-level public name of every ``tramp_tpu`` module, and
    every public method of its public classes, exists at the same place in
    ``tramp_tpu_torch`` (the same module path; a method may be inherited),
    unless ROADMAP's "Code not to port" list names it or its file."""
    import importlib
    skipped = _not_to_port()
    gaps = []
    for path in sorted((REPO / "tramp_tpu").rglob("*.py")):
        rel = path.relative_to(REPO / "tramp_tpu")
        parts = list(rel.with_suffix("").parts)
        if parts[-1] == "__init__":
            parts.pop()
        if any(str(rel).endswith(s) for s in skipped):
            continue
        module = importlib.import_module(".".join(["tramp_tpu_torch"]
                                                  + parts))
        names, methods = _jax_public_names(path)
        for name in names:
            if name in skipped:
                continue
            if not hasattr(module, name):
                gaps.append(f"{module.__name__}.{name}")
                continue
            cls = getattr(module, name)
            gaps += [f"{module.__name__}.{name}.{m}"
                     for m in methods.get(name, ()) if not hasattr(cls, m)]
    assert not gaps, gaps
    # the list names only what the JAX package has
    assert {"ops/dft.py", "USE_PALLAS", "kernel_mode"} <= skipped


#: parameters the port renames on purpose: a JAX PRNG key is a
#: ``torch.Generator`` there
PORT_PARAMETER = {"key": "generator"}


def _jax_parameter_names(path):
    """{public function or ``Class.method``: its named parameters, without
    ``self`` and ``cls``} of a tramp_tpu source file, read with ``ast``;
    properties are left out."""
    import ast

    def named(f):
        a = f.args
        return [p.arg for p in a.posonlyargs + a.args + a.kwonlyargs
                if p.arg not in ("self", "cls")]

    def public(f):
        return (isinstance(f, ast.FunctionDef) and not f.name.startswith("_")
                and not any(isinstance(d, ast.Name) and d.id == "property"
                            for d in f.decorator_list))
    out = {}
    for node in ast.parse(path.read_text()).body:
        if public(node):
            out[node.name] = named(node)
        elif isinstance(node, ast.ClassDef) and not node.name.startswith("_"):
            for f in node.body:
                if public(f):
                    out[f"{node.name}.{f.name}"] = named(f)
    return out


def test_every_public_callable_takes_the_jax_parameter_names():
    """Every public function of ``tramp_tpu``, and every public method of
    its public classes, has a counterpart in ``tramp_tpu_torch`` that takes
    each of its named parameters by that name, unless the counterpart takes
    ``**kwargs`` or ROADMAP's "Code not to port" list names the parameter
    (as `function(parameter)` or `Class.method(parameter)`). A JAX PRNG
    ``key`` is the port's ``generator`` (``PORT_PARAMETER``)."""
    import importlib
    import inspect
    skipped = _not_to_port()
    gaps = []
    for path in sorted((REPO / "tramp_tpu").rglob("*.py")):
        rel = path.relative_to(REPO / "tramp_tpu")
        parts = list(rel.with_suffix("").parts)
        if parts[-1] == "__init__":
            parts.pop()
        if any(str(rel).endswith(s) for s in skipped):
            continue
        module = importlib.import_module(".".join(["tramp_tpu_torch"]
                                                  + parts))
        for qualname, names in _jax_parameter_names(path).items():
            if qualname.split(".")[0] in skipped:
                continue
            port = module
            for attr in qualname.split("."):
                port = getattr(port, attr)
            try:
                params = inspect.signature(port).parameters
            except (TypeError, ValueError):
                gaps.append(f"{module.__name__}.{qualname}: no signature")
                continue
            if any(p.kind == p.VAR_KEYWORD for p in params.values()):
                continue
            gaps += [f"{module.__name__}.{qualname}({name})"
                     for name in names
                     if PORT_PARAMETER.get(name, name) not in params
                     and f"{qualname}({name})" not in skipped]
    assert not gaps, gaps
    # the list's parameter entries name what the JAX package has
    assert "fused_pl_posterior(interpret)" in skipped


def test_parameters_named_as_in_the_jax_package_are_taken():
    """The three callables whose parameter names the guard above asks for:
    ``n`` and ``n_nodes`` change nothing (the JAX package does not use them
    either), and ``stack_pytrees(trees=...)`` is ``stack_models``."""
    import math
    import tramp_tpu_torch as tt
    from tramp_tpu_torch.ensembles.marchenko_pastur_ensemble import (
        MarchenkoPasturEnsemble)
    from tramp_tpu_torch.parallel import stack_models, stack_pytrees
    from tramp_tpu_torch.utils.integration import truncated_gaussian_measure
    m, s = (torch.tensor(v, dtype=torch.float64) for v in (0.3, 1.2))
    want = truncated_gaussian_measure(m, s, 0.0, math.inf, torch.cos)
    got = truncated_gaussian_measure(m, s, 0.0, math.inf, torch.cos, n=7)
    assert torch.equal(got, want)
    ensemble = MarchenkoPasturEnsemble(alpha=0.5)
    assert torch.equal(ensemble.measure(torch.sin, n_nodes=3),
                       ensemble.measure(torch.sin))
    models = [tt.glm_state_evolution(
        alpha=alpha, prior_type="gauss_bernoulli", output_type="gaussian",
        prior_rho=0.25, output_var=1e-2) for alpha in (0.5, 0.7)]
    got = stack_pytrees(trees=models, device="cpu")
    want = stack_models(models, device="cpu")
    assert torch.equal(got.factors[1].alpha, want.factors[1].alpha)
    assert got.factors[1].alpha.flatten().tolist() == [0.5, 0.7]


def _root_not_ported():
    """The files ROADMAP.md's "Root modules not ported now" list names: the
    backquoted name that opens each item of that paragraph (to its first
    blank line)."""
    text = (REPO / "ROADMAP.md").read_text()
    start = re.search(r"^Root modules not ported now", text, re.M).start()
    section = text[start:text.index("\n\n", start)]
    return set(re.findall(r"^- `([^`]+)`", section, re.M))


def test_every_root_module_of_the_jax_package_has_a_counterpart():
    """Every ``*.py`` at the repo's root that imports the JAX package
    (``tramp_tpu``, not ``tramp_tpu_torch``) has a counterpart in the port,
    ``tramp_tpu_torch/<its name without the outer underscores>.py``, or is
    named in ROADMAP's "Root modules not ported now" list."""
    imports = re.compile(r"^\s*(import|from)\s+tramp_tpu(\.|\s|$)", re.M)
    roots = [p for p in sorted(REPO.glob("*.py"))
             if imports.search(p.read_text())]
    skipped = _root_not_ported()
    missing = [p.name for p in roots if p.name not in skipped
               and not (REPO / "tramp_tpu_torch"
                        / f"{p.stem.strip('_')}.py").is_file()]
    assert not missing, f"root modules without a counterpart: {missing}"
    assert "__graft_entry__.py" in {p.name for p in roots}
    assert skipped == {"bench.py"}


def test_structured_factors_need_a_card_or_an_explicit_cpu():
    """The structured channels, the ensembles of item 4c, the TV builders
    and the low-rank state evolution put their arrays on the card unless
    told otherwise, so each raises here; with device='cpu' a TV regression
    builds and solves, and the low-rank solver runs where its inputs are."""
    code = (
        "import numpy as np, torch\n"
        "from tramp_tpu_torch import channels, ensembles, models, parallel\n"
        "from tramp_tpu_torch.channels import low_rank\n"
        "A = np.random.RandomState(0).randn(6, 8) / np.sqrt(8)\n"
        "y = A @ np.cumsum(np.ones(8))\n"
        "calls = {\n"
        "    'conv': lambda: channels.ConvChannel(np.ones(4)),\n"
        "    'blur_2d': lambda: channels.Blur2DChannel((1.0, 1.0), (4, 4)),\n"
        "    'gradient': lambda: channels.GradientChannel((4, 5)),\n"
        "    'rotation': lambda: channels.RotationChannel(np.eye(3)),\n"
        "    'ensemble': lambda: ensembles.get_ensemble(\n"
        "        'rotation', N=3).generate(),\n"
        "    'tv': lambda: models.tv_regression(A, y, x_shape=(8,),\n"
        "        grad_scale=1.0, noise_var=0.1, prior_var=1.0),\n"
        "    'se': lambda: low_rank.se_matrix_factorization_kk(\n"
        "        1.0, 1.0, 2.0, 'UV', K=2)}\n"
        "for name, call in calls.items():\n"
        "    try:\n"
        "        call()\n"
        "    except RuntimeError as e:\n"
        "        assert \"device='cpu'\" in str(e), (name, e)\n"
        "    else:\n"
        "        raise SystemExit(name + ': no error without a card')\n"
        "cpu = dict(device='cpu', dtype=torch.float64)\n"
        "model = models.tv_regression(A, y, x_shape=(8,), grad_scale=1.0,\n"
        "    noise_var=0.1, prior_var=1.0, **cpu)\n"
        "init = __import__('tramp_tpu_torch').ConstantInit(a=1.0, b=1.0)\n"
        "post, n_iter = parallel.dispatch_solver(model, damping=0.1,\n"
        "    max_iter=30).solve(model, initializer=init)\n"
        "assert post['x']['r'].device.type == 'cpu' and int(n_iter) > 1\n"
        "out = low_rank.vamp_matrix_factorization(1.0, 1.0,\n"
        "    torch.zeros(6, 2, **cpu), torch.zeros(8, 2, **cpu), 2.0,\n"
        "    torch.ones(6, 8, **cpu))\n"
        "assert out[0].device.type == 'cpu'\n"
        "low_rank.se_matrix_factorization_kk(1.0, 1.0, 2.0, 'UV', K=2, **cpu)\n")
    proc = _run(code, env=NO_CARD)
    assert proc.returncode == 0, proc.stderr + proc.stdout


def test_new_factors_need_a_card_or_an_explicit_cpu():
    """A perceptron built without a device draws its samples on the card
    and raises here; with device='cpu' it samples and solves, and its state
    evolution runs on the CPU when asked to."""
    code = (
        "import torch\n"
        "import tramp_tpu_torch as tt\n"
        "from tramp_tpu_torch import parallel\n"
        "from tramp_tpu_torch.priors import BinaryPrior\n"
        "try:\n"
        "    BinaryPrior(size=4).sample(None)\n"
        "except RuntimeError as e:\n"
        "    assert \"device='cpu'\" in str(e), e\n"
        "else:\n"
        "    raise SystemExit('no error without a card')\n"
        "g = torch.Generator().manual_seed(0)\n"
        "teacher = tt.glm_generative(N=40, alpha=1.0,\n"
        "    ensemble_type='gaussian', prior_type='binary',\n"
        "    output_type='sgn', generator=g, device='cpu',\n"
        "    dtype=torch.float64, prior_p_pos=0.25)\n"
        "y = teacher.sample(g)['y']\n"
        "student = teacher.to_observed({'y': y})\n"
        "post, n_iter = parallel.dispatch_solver(student,\n"
        "    damping=0.1, max_iter=50).solve(student)\n"
        "assert post['x']['r'].device.type == 'cpu' and int(n_iter) > 1\n"
        "model = tt.glm_state_evolution(alpha=0.8, prior_type='binary',\n"
        "    output_type='sgn', prior_p_pos=0.25)\n"
        "try:\n"
        "    tt.StateEvolution(model)\n"
        "except RuntimeError as e:\n"
        "    assert \"device='cpu'\" in str(e), e\n"
        "else:\n"
        "    raise SystemExit('no error without a card')\n"
        "se = tt.StateEvolution(model, device='cpu').iterate(max_iter=20)\n"
        "assert 0 < float(se.get_variable_data('x')['v']) < 1\n")
    proc = _run(code, env=NO_CARD)
    assert proc.returncode == 0, proc.stderr + proc.stdout


def test_tree_and_complex_factors_need_a_card_or_an_explicit_cpu():
    """The factors and builders of the complex channels, the shape channels
    and the composite models put their arrays on the card unless told
    otherwise, so each raises here; with device='cpu' the committee and
    the complex GLM build and solve."""
    code = (
        "import numpy as np, torch\n"
        "import tramp_tpu_torch as tt\n"
        "from tramp_tpu_torch import channels, ensembles, models, parallel\n"
        "rng = np.random.RandomState(0)\n"
        "W = rng.randn(6, 4) + 1j * rng.randn(6, 4)\n"
        "U = np.linalg.qr(rng.randn(4, 4) + 1j * rng.randn(4, 4))[0]\n"
        "weights = [rng.randn(5, 2), rng.randn(7, 5)]\n"
        "biases = [rng.randn(5), rng.randn(7)]\n"
        "calls = {\n"
        "    'complex_linear': lambda: channels.ComplexLinearChannel(W),\n"
        "    'unitary': lambda: channels.UnitaryChannel(U),\n"
        "    'bias': lambda: channels.BiasChannel(np.ones(3)),\n"
        "    'ensemble': lambda: ensembles.get_ensemble(\n"
        "        'complex_gaussian', M=3, N=2).generate(),\n"
        "    'committee': lambda: models.soft_committee(\n"
        "        K=2, N=4, alpha=1.0, ensemble_type='gaussian',\n"
        "        prior_mean=0.0, prior_var=1.0, noise_var=0.1),\n"
        "    'vae': lambda: models.vae_prior_block(weights, biases,\n"
        "                                           latent_dim=2),\n"
        "    'complex_glm': lambda: tt.glm_generative(\n"
        "        N=4, alpha=2.0, ensemble_type='complex_gaussian',\n"
        "        prior_type='gauss_bernoulli', output_type='modulus')}\n"
        "for name, call in calls.items():\n"
        "    try:\n"
        "        call()\n"
        "    except RuntimeError as e:\n"
        "        assert \"device='cpu'\" in str(e), (name, e)\n"
        "    else:\n"
        "        raise SystemExit(name + ': no error without a card')\n"
        "g = torch.Generator().manual_seed(0)\n"
        "for build in (\n"
        "        lambda: models.soft_committee(\n"
        "            K=2, N=20, alpha=1.5, ensemble_type='gaussian',\n"
        "            prior_mean=0.1, prior_var=1.0, noise_var=1e-2,\n"
        "            generator=g, device='cpu', dtype=torch.float64),\n"
        "        lambda: tt.glm_generative(\n"
        "            N=20, alpha=2.0, ensemble_type='complex_gaussian',\n"
        "            prior_type='gauss_bernoulli', output_type='modulus',\n"
        "            generator=g, device='cpu', dtype=torch.float64)):\n"
        "    teacher = build()\n"
        "    student = teacher.to_observed({'y': teacher.sample(g)['y']})\n"
        "    post, n_iter = parallel.dispatch_solver(\n"
        "        student, damping=0.3, max_iter=30).solve(student)\n"
        "    r = next(iter(post.values()))['r']\n"
        "    assert r.device.type == 'cpu' and int(n_iter) > 1\n")
    proc = _run(code, env=NO_CARD)
    assert proc.returncode == 0, proc.stderr + proc.stdout


def test_checks_need_a_card_or_an_explicit_cpu():
    "A check of a factor built without a device runs on the card or raises."
    code = (
        "from tramp_tpu_torch import checks\n"
        "from tramp_tpu_torch.priors import BinaryPrior\n"
        "prior = BinaryPrior(size=1, p_pos=0.6)\n"
        "try:\n"
        "    checks.check_prior_grad_EP(prior)\n"
        "except RuntimeError as e:\n"
        "    assert \"device='cpu'\" in str(e), e\n"
        "else:\n"
        "    raise SystemExit('no error without a card')\n"
        "df = checks.check_prior_grad_EP(prior, device='cpu')\n"
        "assert df['r_err'].max() < 1e-8\n")
    proc = _run(code, env=NO_CARD)
    assert proc.returncode == 0, proc.stderr + proc.stdout


def test_kernel_module_imports_without_nvcc_or_gpu():
    env = dict(os.environ, PATH="/usr/bin:/bin", CUDA_VISIBLE_DEVICES="")
    code = ("import shutil, torch; "
            "from tramp_tpu_torch.ops import pl_fused; "
            "assert shutil.which('nvcc') is None; "
            "assert not torch.cuda.is_available(); "
            "assert not pl_fused._fns")
    proc = _run(code, env=env)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    """Kernel vs plain version on the card: rtol 1e-10 in float64 (the JAX
    package's Pallas tolerance) and 1e-4 in float32, relative to each
    element with a floor of rtol times the stream's largest magnitude."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    for dtype, rtol in ((torch.float64, 1e-10), (torch.float32, 1e-4)):
        for n in (1, 2048, 100_003):
            az, bz, ax, bx = _inputs(n, dtype, device="cuda", seed=n)
            for channel in CHANNELS:
                before = pl_fused.pl_posterior.launches
                got = pl_fused.pl_posterior(az, bz, ax, bx,
                                            channel.region_specs)
                assert pl_fused.pl_posterior.launches == before + 1
                want = pl_fused.pl_posterior_plain(az, bz, ax, bx,
                                                   channel.region_specs)
                torch.cuda.synchronize()
                for g, w in zip(got, want):
                    bound = rtol * (w.abs() + w.abs().max())
                    assert bool(((g - w).abs() <= bound).all()), (
                        channel.name, dtype, n)
        # lanes: a precision per lane, read as a[lane] on the device
        for n in (2048, 16684):
            args = _lane_inputs(3, n, dtype, device="cuda", seed=n)
            for channel in CHANNELS:
                got = pl_fused.pl_posterior(*args, channel.region_specs)
                want = pl_fused.pl_posterior_plain(*args,
                                                   channel.region_specs)
                torch.cuda.synchronize()
                for g, w in zip(got, want):
                    bound = rtol * (w.abs() + w.abs().max())
                    assert g.shape == w.shape == (3, n)
                    assert bool(((g - w).abs() <= bound).all()), (
                        channel.name, dtype, n, "lanes")


@pytest.mark.cuda
def test_message_kernels_match_plain_on_card():
    """Message kernels vs their plain versions on the card, a_new and b_new:
    rtol 1e-10 in float64 and 1e-4 in float32, relative to each element with
    a floor of rtol times the stream's largest magnitude; one launch counted
    up to 16384 elements and two above; scalar and per-element precisions; and the
    same bits from two calls on the same inputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    for dtype, rtol in ((torch.float64, 1e-10), (torch.float32, 1e-4)):
        for n in (1, 2047, 2048, 16384, 100_003):
            az, bz, ax, bx = _inputs(n, dtype, device="cuda", seed=n)
            cases = [(az, ax)]
            if n == 2047:
                rng = np.random.RandomState(1)
                cases.append(tuple(
                    torch.as_tensor(lo + rng.rand(n), dtype=dtype,
                                    device="cuda") for lo in (1.2, 0.4)))
            for az_c, ax_c in cases:
                for channel in CHANNELS:
                    for fused, plain in MESSAGES:
                        before = fused.launches
                        got = fused(az_c, bz, ax_c, bx, channel.region_specs)
                        again = fused(az_c, bz, ax_c, bx,
                                      channel.region_specs)
                        per_call = 1 if n <= pl_fused.CLUSTER_MAX else 2
                        assert fused.launches == before + 2 * per_call
                        want = plain(az_c, bz, ax_c, bx,
                                     channel.region_specs)
                        torch.cuda.synchronize()
                        for g, g2, w in zip(got, again, want):
                            assert g.shape == w.shape
                            assert torch.equal(g, g2)
                            bound = rtol * (w.abs() + w.abs().max())
                            assert bool(((g - w).abs() <= bound).all()), (
                                channel.name, fused.__name__, dtype, n)
        # lanes: the mean, the update and the clamps per lane; the launch
        # count does not depend on the lanes; lane i has the bits of the
        # single launch on lane i's data
        for n in (2048, 16684):
            az, bz, ax, bx = _lane_inputs(3, n, dtype, device="cuda", seed=n)
            for channel in CHANNELS:
                for fused, plain in MESSAGES:
                    before = fused.launches
                    got = fused(az, bz, ax, bx, channel.region_specs)
                    per_call = 1 if n <= pl_fused.CLUSTER_MAX else 2
                    assert fused.launches == before + per_call
                    want = plain(az, bz, ax, bx, channel.region_specs)
                    for g, w in zip(got, want):
                        assert g.shape == w.shape
                        bound = rtol * (w.abs() + w.abs().max())
                        assert bool(((g - w).abs() <= bound).all()), (
                            channel.name, fused.__name__, dtype, n, "lanes")
                    for i in range(3):
                        single = fused(az[i, 0], bz[i], ax[i, 0], bx[i],
                                       channel.region_specs)
                        assert torch.equal(got[0][i, 0], single[0])
                        assert torch.equal(got[1][i], single[1])


@pytest.mark.cuda
def test_special_function_derivatives_on_card():
    """The autograd Functions of utils/special.py on the card: first
    derivatives equal to the CPU's at rtol 1e-12 (float64), second ones at
    rtol 1e-5, where log_norm_cdf_prime's cancels at x = -1e3 (as in
    tests/test_torch_checks.py); NaN and infinities where the CPU has
    them."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    from tramp_tpu_torch.utils import special
    xs = [-1e3, -40.0, -5.0, 0.0, 5.0, 40.0, 1e3, np.inf, -np.inf]
    for name in ("erfcx", "log_Phi_erfcx", "log_norm_cdf_prime"):
        out = []
        for device in ("cpu", "cuda"):
            x = torch.tensor(xs, dtype=torch.float64, device=device,
                             requires_grad=True)
            d1, = torch.autograd.grad(getattr(special, name)(x).sum(), x,
                                      create_graph=True)
            d2, = torch.autograd.grad(d1.sum(), x)
            out.append([d.detach().cpu().numpy() for d in (d1, d2)])
        for got, want, rtol in zip(out[1], out[0], (1e-12, 1e-5)):
            np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-300,
                                       err_msg=name)


# -- the gallery (tramp_tpu_torch/examples) --------------------------------
JAX_EXAMPLES = sorted(p.relative_to(REPO / "examples")
                      for p in (REPO / "examples").rglob("*.py"))
GALLERY = [".".join(p.with_suffix("").parts) for p in JAX_EXAMPLES]


def test_every_jax_example_has_a_counterpart():
    """Each script of the JAX package's examples/ has one at the same path
    under tramp_tpu_torch/examples/, and the package's __init__ imports
    none of them."""
    assert len(JAX_EXAMPLES) == 18
    missing = [str(p) for p in JAX_EXAMPLES
               if not (REPO / "tramp_tpu_torch" / "examples" / p).is_file()]
    assert not missing, f"gallery scripts without a counterpart: {missing}"
    init = (REPO / "tramp_tpu_torch" / "__init__.py").read_text()
    assert "examples" not in init


@pytest.mark.parametrize("name", GALLERY)
def test_gallery_script_needs_a_card_unless_told_cpu(name, monkeypatch):
    """``main([])`` raises where there is no card (config.default_device),
    before it computes anything; ``--device cpu`` is the way to the CPU."""
    import importlib
    module = importlib.import_module(f"tramp_tpu_torch.examples.{name}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main([])


@pytest.mark.parametrize("name", GALLERY)
def test_gallery_script_runs_as_a_module(name, monkeypatch, capsys):
    "``python -m tramp_tpu_torch.examples.<name> --help`` reaches main."
    import runpy
    # a fresh import as __main__, not the module an earlier test imported
    monkeypatch.delitem(sys.modules, f"tramp_tpu_torch.examples.{name}",
                        raising=False)
    monkeypatch.setattr(sys, "argv", [name, "--help"])
    with pytest.raises(SystemExit) as done:
        runpy.run_module(f"tramp_tpu_torch.examples.{name}",
                         run_name="__main__")
    assert done.value.code == 0
    assert "--device" in capsys.readouterr().out
