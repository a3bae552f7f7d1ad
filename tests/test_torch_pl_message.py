"""The fused EP messages of the piecewise-linear channels,
tramp_tpu_torch.ops.pl_forward_message / pl_backward_message, against
tramp_tpu, float64 on the CPU, for all eight channel classes.

On CPU tensors the wrappers run their plain twins, so this file holds the
arithmetic the CUDA kernels are compared with on the card.

Tolerances (torch_parity.assert_close: relative to each element, with a
floor of rtol times the array's largest finite magnitude):
- against the JAX channel's ``compute_forward_message`` /
  ``compute_backward_message`` (its jnp region path): rtol 1e-12, the
  tolerance tests/test_torch_factors.py holds these messages to (the same
  formulas; only elementwise roundoff differs), with scalar and with
  per-element precisions;
- against the JAX Pallas kernel in interpret mode followed by the JAX
  ``compute_ab_new``: rtol 1e-10, the tolerance of
  tests/test_pallas_ops.py:38-42 (the kernel evaluates erfcx, erf and erfc
  by Chebyshev forms);
- against the composition the channels ran before the fusion
  (``compute_*_posterior`` then ``compute_ab_new``, the base Channel's
  methods): bit-identical.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tramp_tpu_torch import channels
from tramp_tpu_torch.channels.base_channel import Channel
from tramp_tpu_torch.ops import (
    pl_forward_message, pl_backward_message,
    pl_forward_message_plain, pl_backward_message_plain,
)
from tramp_tpu_torch.ops import _build, pl_fused

# chip_smoke.py, at the root: the layouts and the card's checks of them
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

F64 = torch.float64
PL_CHANNELS = {
    "sgn": ("SgnChannel", {}), "abs": ("AbsChannel", {}),
    "a-abs": ("AsymmetricAbsChannel", {"shift": 0.1}),
    "relu": ("ReluChannel", {}), "l-relu": ("LeakyReluChannel", {"slope": 0.3}),
    "h-tanh": ("HardTanhChannel", {}), "h-sigm": ("HardSigmoidChannel", {}),
    "door": ("SymmetricDoorChannel", {"width": 0.7}),
}
DIRECTIONS = {
    "forward": (pl_forward_message, pl_forward_message_plain,
                "compute_forward_message"),
    "backward": (pl_backward_message, pl_backward_message_plain,
                 "compute_backward_message"),
}
N = 203  # no multiple of 4 or 128


def _jax():
    """(jax.numpy, tramp_tpu.base, tramp_tpu.channels, the JAX kernel's
    entry point, the parity check), imported at first use: the card-only
    cases at the end of this file run where JAX is not installed."""
    import jax.numpy as jnp
    from tramp_tpu import base as jbase
    from tramp_tpu import channels as jchannels
    from tramp_tpu.ops import fused_pl_posterior
    from torch_parity import assert_close
    return jnp, jbase, jchannels, fused_pl_posterior, assert_close


def _pair(name):
    cls, kw = PL_CHANNELS[name]
    jchannels = _jax()[2]
    return getattr(channels, cls)(**kw), getattr(jchannels, cls)(**kw)


def _inputs(per_element, seed=20):
    "(az, bz, ax, bx) as numpy; precisions scalar or one per element."
    rng = np.random.RandomState(seed)
    bz, bx = 2 * rng.randn(N), 2 * rng.randn(N)
    if per_element:
        return 1.2 + rng.rand(N), bz, 0.4 + rng.rand(N), bx
    return np.float64(1.7), bz, np.float64(0.9), bx


def _t(x):
    return torch.as_tensor(np.asarray(x), dtype=F64)


@pytest.mark.parametrize("precisions", ["scalar", "per_element"])
@pytest.mark.parametrize("direction", list(DIRECTIONS))
@pytest.mark.parametrize("name", list(PL_CHANNELS))
def test_message_matches_jax_channel(name, direction, precisions):
    jnp, _, _, _, assert_close = _jax()
    port, ref = _pair(name)
    fused, _, method = DIRECTIONS[direction]
    args = _inputs(precisions == "per_element")
    a_new, b_new = fused(*map(_t, args), port.region_specs)
    a_ref, b_ref = getattr(ref, method)(*map(jnp.asarray, args))
    assert_close(a_new, a_ref, 1e-12, what="a_new")
    assert_close(b_new, b_ref, 1e-12, what="b_new")
    own = args[2] if direction == "forward" else args[0]
    assert a_new.shape == np.shape(own) and b_new.shape == (N,)


@pytest.mark.parametrize("name", ["relu", "abs", "h-tanh"])
def test_message_matches_pallas_interpret(name):
    "Half-infinite regions with and without slope, and a finite one."
    jnp, jbase, _, fused_pl_posterior, assert_close = _jax()
    port, ref = _pair(name)
    az, bz, ax, bx = _inputs(False)
    rz, vz, rx, vx, _ = fused_pl_posterior(
        az, jnp.asarray(bz), ax, jnp.asarray(bx), ref.region_specs,
        interpret=True)
    wanted = {
        "forward": jbase.compute_ab_new(rx, jnp.mean(vx), ax,
                                        jnp.asarray(bx)),
        "backward": jbase.compute_ab_new(rz, jnp.mean(vz), az,
                                         jnp.asarray(bz)),
    }
    for direction, (fused, _, _) in DIRECTIONS.items():
        got = fused(_t(az), _t(bz), _t(ax), _t(bx), port.region_specs)
        for what, g, w in zip(("a_new", "b_new"), got, wanted[direction]):
            assert_close(g, w, 1e-10, what=f"{direction} {what}")


@pytest.mark.parametrize("precisions", ["scalar", "per_element"])
@pytest.mark.parametrize("direction", list(DIRECTIONS))
@pytest.mark.parametrize("name", list(PL_CHANNELS))
def test_message_equals_unfused_composition(name, direction, precisions):
    """The wrapper on CPU tensors, its plain twin, the channel's method and
    the base Channel's posterior-then-update are the same bits."""
    port, _ = _pair(name)
    fused, plain, method = DIRECTIONS[direction]
    args = tuple(map(_t, _inputs(precisions == "per_element", seed=21)))
    unfused = getattr(Channel, method)(port, *args)
    for got in (fused(*args, port.region_specs),
                plain(*args, port.region_specs),
                getattr(port, method)(*args)):
        for g, w in zip(got, unfused):
            assert g.shape == w.shape and torch.equal(g, w)


@pytest.mark.parametrize("direction", list(DIRECTIONS))
def test_message_propagates_nan(direction):
    "A NaN input reaches a_new and b_new, where the finite guard sees it."
    fused, _, _ = DIRECTIONS[direction]
    az, bz, ax, bx = map(_t, _inputs(False))
    bz = bz.clone()
    bz[5] = float("nan")
    a_new, b_new = fused(az, bz, ax, bx, channels.ReluChannel().region_specs)
    assert bool(torch.isnan(a_new)) and bool(torch.isnan(b_new).all())


# -- lanes: (B, n) inputs with a precision per lane ---------------------------

B = 3


def _lane_inputs(seed=22):
    "(az, bz, ax, bx) as numpy: B lanes of N elements, precisions (B,)."
    rng = np.random.RandomState(seed)
    return (1.2 + rng.rand(B), 2 * rng.randn(B, N), 0.4 + rng.rand(B),
            2 * rng.randn(B, N))


def _lane_tensors(az, bz, ax, bx):
    "The port's layout: precisions (B, 1) beside messages (B, N)."
    return _t(az).reshape(B, 1), _t(bz), _t(ax).reshape(B, 1), _t(bx)


@pytest.mark.parametrize("direction", list(DIRECTIONS))
@pytest.mark.parametrize("name", list(PL_CHANNELS))
def test_lane_message_matches_vmapped_jax_channel(name, direction):
    """Per-lane precisions against ``jax.vmap`` of the JAX channel's message
    (its jnp region path on the CPU): rtol 1e-10."""
    jnp, _, _, _, assert_close = _jax()
    import jax
    port, ref = _pair(name)
    fused, plain, method = DIRECTIONS[direction]
    args = _lane_inputs()
    a_ref, b_ref = jax.vmap(getattr(ref, method))(*map(jnp.asarray, args))
    for fn in (fused, plain):
        a_new, b_new = fn(*_lane_tensors(*args), port.region_specs)
        assert a_new.shape == (B, 1) and b_new.shape == (B, N)
        assert_close(a_new.reshape(B), a_ref, 1e-10, what="a_new")
        assert_close(b_new, b_ref, 1e-10, what="b_new")


def test_lane_message_matches_vmapped_pallas_interpret():
    """The JAX kernel under ``jax.vmap`` in interpret mode, then the JAX
    ``compute_ab_new`` per lane: rtol 1e-10."""
    jnp, jbase, _, fused_pl_posterior, assert_close = _jax()
    import jax
    port, ref = _pair("h-tanh")
    args = _lane_inputs()
    az, bz, ax, bx = map(jnp.asarray, args)
    rz, vz, rx, vx, _ = jax.vmap(
        lambda a, b, c, d: fused_pl_posterior(
            a, b, c, d, ref.region_specs, interpret=True))(az, bz, ax, bx)
    wanted = {
        "forward": jax.vmap(jbase.compute_ab_new)(
            rx, jnp.mean(vx, axis=1), ax, bx),
        "backward": jax.vmap(jbase.compute_ab_new)(
            rz, jnp.mean(vz, axis=1), az, bz),
    }
    for direction, (fused, _, _) in DIRECTIONS.items():
        a_new, b_new = fused(*_lane_tensors(*args), port.region_specs)
        assert_close(a_new.reshape(B), wanted[direction][0], 1e-10,
                     what=f"{direction} a_new")
        assert_close(b_new, wanted[direction][1], 1e-10,
                     what=f"{direction} b_new")


@pytest.mark.parametrize("other", ["scalar", "per_lane", "per_element"])
@pytest.mark.parametrize("direction", list(DIRECTIONS))
def test_lane_of_a_batched_message_is_the_single_message(direction, other):
    """Lane i of a batched call against the single call on lane i's data
    (rtol 1e-13: a mean along an axis may sum in another order than a mean
    over everything), whatever the shape of the other side's precision."""
    assert_close = _jax()[4]
    fused, _, _ = DIRECTIONS[direction]
    specs = channels.HardTanhChannel().region_specs
    az, bz, ax, bx = _lane_tensors(*_lane_inputs(seed=23))
    others = {"scalar": torch.tensor(0.9, dtype=F64), "per_lane": None,
              "per_element": 0.4 + torch.rand(B, N, dtype=F64)}
    if others[other] is not None:
        if direction == "forward":
            az = others[other]
        else:
            ax = others[other]
    a_new, b_new = fused(az, bz, ax, bx, specs)
    assert a_new.shape == (B, 1)

    def lane(a, i):
        return a if a.ndim == 0 else a[i].reshape(()) if a.shape[1] == 1 \
            else a[i]

    for i in range(B):
        a_i, b_i = fused(lane(az, i), bz[i], lane(ax, i), bx[i], specs)
        assert_close(a_new[i, 0], a_i, 1e-13, what=f"lane {i} a_new")
        assert_close(b_new[i], b_i, 1e-13, what=f"lane {i} b_new")


@pytest.mark.parametrize("direction", list(DIRECTIONS))
def test_lane_message_keeps_a_nan_in_its_lane(direction):
    fused, _, _ = DIRECTIONS[direction]
    az, bz, ax, bx = _lane_tensors(*_lane_inputs())
    bz = bz.clone()
    bz[1, 5] = float("nan")
    a_new, b_new = fused(az, bz, ax, bx, channels.ReluChannel().region_specs)
    assert torch.isnan(a_new).reshape(B).tolist() == [False, True, False]
    assert torch.isnan(b_new).all(1).tolist() == [False, True, False]


# -- the laned layouts: shapes and scratch on meta tensors, kernels on a card

#: n of every layout a message with lanes takes: one block per lane (up to
#: pl_fused.LANE_MAX, several lanes per block up to 1024), one cluster per
#: lane (up to CLUSTER_MAX) and two launches
LAYOUT_N = tuple(sorted(set(chip_smoke.LAYOUT_SIZES)
                        | {pl_fused.LANE_MAX, pl_fused.LANE_MAX + 1}))
LAYOUT_LANES = chip_smoke.LAYOUT_LANES
#: which precision is one per element; the other is one per lane
PRECISIONS = {"per_lane": None, "az_per_element": 0, "ax_per_element": 2}


def _layout_inputs(lanes, n, precisions, dtype=F64, device="cpu", seed=0):
    """(az, bz, ax, bx): messages (lanes, n), precisions (lanes, 1) or
    (lanes, n)."""
    rng = np.random.RandomState(seed)
    out = [1.2 + rng.rand(lanes, 1), 2 * rng.randn(lanes, n),
           0.4 + rng.rand(lanes, 1), 2 * rng.randn(lanes, n)]
    which = PRECISIONS[precisions]
    if which is not None:
        out[which] = out[which] + rng.rand(lanes, n)
    return tuple(torch.as_tensor(x, dtype=dtype, device=device) for x in out)


@pytest.mark.parametrize("precisions", list(PRECISIONS))
@pytest.mark.parametrize("direction", list(DIRECTIONS))
@pytest.mark.parametrize("lanes", LAYOUT_LANES)
def test_lane_message_shapes_on_meta(lanes, direction, precisions):
    """On meta tensors the outputs have the plain version's shapes and
    dtype for every layout's n: a_new per element for a precision per
    element of the message's own side, else one per lane."""
    fused, plain, _ = DIRECTIONS[direction]
    specs = channels.ReluChannel().region_specs
    for n in LAYOUT_N + (pl_fused.CLUSTER_MAX, pl_fused.CLUSTER_MAX + 1):
        args = _layout_inputs(lanes, n, precisions)
        want = plain(*args, specs) if n < 600 else None
        got = fused(*(t.to("meta") for t in args), specs)
        own = args[2] if direction == "forward" else args[0]
        shapes = (own.shape if own.shape[1] == n else (lanes, 1),
                  (lanes, n))
        for g, shape in zip(got, shapes):
            assert g.device.type == "meta" and g.dtype == F64
            assert g.shape == shape, (n, g.shape, shape)
        if want is not None:
            assert [w.shape for w in want] == [g.shape for g in got]


@pytest.mark.parametrize("lanes", LAYOUT_LANES)
def test_one_launch_with_lanes_allocates_no_partials(lanes, monkeypatch):
    """The wrapper allocates the scratch row of block sums only where a
    message is two launches (above CLUSTER_MAX elements per lane): none on
    the one-block-per-lane or one-cluster-per-lane layouts, one row of
    ceil(n / 512) doubles per lane above."""
    seen = []
    outputs = pl_fused._message_outputs

    def spy(*args):
        out = outputs(*args)
        seen.append(out[2])
        return out
    monkeypatch.setattr(pl_fused, "_message_outputs", spy)
    specs = channels.ReluChannel().region_specs
    for n in LAYOUT_N + (pl_fused.CLUSTER_MAX, pl_fused.CLUSTER_MAX + 300):
        for fused, _, _ in DIRECTIONS.values():
            fused(*(t.to("meta") for t in _layout_inputs(lanes, n,
                                                         "per_lane")),
                  specs)
            partials = seen.pop()
            if n <= pl_fused.CLUSTER_MAX:
                assert partials is None, n
            else:
                assert partials.shape == (lanes, -(-n // 512))
                assert partials.dtype == F64


@pytest.mark.cuda
@pytest.mark.parametrize("precisions", list(PRECISIONS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["float32", "float64"])
@pytest.mark.parametrize("name", ["relu", "h-tanh", "stairs"])
def test_lane_messages_on_card(name, dtype, precisions):
    """Each layout with lanes against the plain version on the card, rtol
    1e-4 in float32 and 1e-10 in float64, relative to each element with a
    floor of rtol times the stream's largest magnitude, plus what rounding
    alone moves an element by; one launch counted up to CLUSTER_MAX
    elements per lane, two above; and every lane with the bits of the
    single launch on its data. The checks are phase 3's own
    (``chip_smoke.compare_lane_layouts``), here one channel, float type and
    precision layout a case; "stairs" has four regions, more than any
    channel of the repo."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    if name == "stairs":
        channel = chip_smoke.stairs()
    else:
        cls, kw = PL_CHANNELS[name]
        channel = getattr(channels, cls)(**kw)
    chip_smoke.compare_lane_layouts(
        torch, pl_fused, (channel,), dtypes=(dtype,),
        per_elements=({"per_lane": None, "az_per_element": "az",
                       "ax_per_element": "ax"}[precisions],))


def test_message_kernels_build_without_contraction(monkeypatch, tmp_path):
    """The message kernels are compiled with -fmad=false, and the posterior
    kernel without it: lane i of a batched message has its single launch's
    bits because nvcc fuses no product that csrc/pl_common.cuh does not
    fuse itself. The commands are read from a build whose nvcc fails."""
    commands = []

    class Failing:
        returncode = 1

        def __init__(self, cmd, **kwargs):
            commands.append(cmd)

        def wait(self):
            return 1
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(pl_fused, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(pl_fused.subprocess, "Popen", Failing)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        pl_fused.build()
    by_source = {}
    for cmd in commands:
        by_source.setdefault(Path(cmd[-1]).name, []).append(cmd)
    assert sorted(by_source) == ["pl_message.cu", "pl_posterior.cu"]
    for source, cmds in by_source.items():
        assert len(cmds) == 2  # float32 and float64
        for cmd in cmds:
            assert ("-fmad=false" in cmd) == (source == "pl_message.cu")
