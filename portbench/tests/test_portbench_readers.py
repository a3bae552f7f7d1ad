"""Each metric reader on a synthetic run and a synthetic profiler trace."""
import math
import types

import pytest

from portbench import counts, manifest, trace

US = 1e6   # the profiler's clock is in microseconds


def events():
    """Two program windows of 1 s; in each a GEMM of 0.4 s, a message kernel
    of 0.1 s, a copy of 0.05 s overlapping the GEMM, and host spans; a
    draw's kernel outside the windows."""
    out = []
    for k, t in enumerate((0.0, 2.0)):
        out += [("portbench.program", False, t * US, (t + 1) * US),
                ("portbench.solve", False, t * US, (t + 0.9) * US),
                ("portbench.readout", False, (t + 0.9) * US, (t + 1) * US),
                ("portbench.draw", False, (t - 0.5) * US, (t - 0.1) * US),
                ("curand_normal_kernel", True, (t - 0.4) * US,
                 (t - 0.3) * US),
                ("sm90_xmma_gemm_f32f32_f32f32", True, (t + 0.1) * US,
                 (t + 0.5) * US),
                ("Memcpy DtoH", True, (t + 0.45) * US, (t + 0.5) * US),
                ("void pl_message_lanes_kernel<float, 2, 0>", True,
                 (t + 0.6) * US, (t + 0.7) * US),
                # the profiler's copy of a range on the device's timeline
                ("portbench.solve", True, t * US, (t + 0.9) * US)]
    return out


def fake_run(timeline=True, lanes=2048, config="relu_net_f64.lanes2048"):
    cell = manifest.Cell(config)
    calls = [{"lanes": lanes, "solved": lanes - 1, "n_iter_sum": 20 * lanes,
              "iterations": 25, "seconds": 0.5 + 0.1 * i, "wall": 0.6,
              "profiled": i in (1, 2)} for i in range(10)]
    return types.SimpleNamespace(
        calls=calls, window_s=6.0, setup_s=9.5,
        peak_window_bytes=3 * 2**30, device=types.SimpleNamespace(
            type="cuda"), traced_calls=calls[1:3],
        timeline=trace.Timeline.from_events(events()) if timeline else None,
        launches={"pl_forward_message": 1, "pl_backward_message": 1,
                  "pl_posterior": 0},
        config=cell.config, config_module=cell.config_module,
        kernel_names=manifest.read_json(
            manifest.HERE / "metrics" / "kernel_names.json"),
        note=lambda line: None)


def read(name, run):
    return manifest.metric_reader(name).read(run)


def test_timeline_reduction():
    tl = trace.Timeline.from_events(events())
    assert tl.window_s == pytest.approx(2.0)
    assert len(tl.device) == 6 and len(tl.kernels()) == 4
    assert tl.busy_s == pytest.approx(2 * 0.5)
    gaps = tl.gaps()
    assert sum(e - s for s, e in gaps) == pytest.approx(1.0)
    # gaps at 0-0.1, 0.5-0.6 and 0.7-1.0 of each window; the last one's
    # middle, 0.85, lies in the solve span
    assert tl.idle_gaps() == [["solve", pytest.approx(1.0)]]
    ops = dict((n, s) for n, s in tl.device_ops())
    assert ops["sm90_xmma_gemm_f32f32_f32f32"] == pytest.approx(0.8)
    assert "curand_normal_kernel" not in ops


def test_end_to_end_readers():
    run = fake_run()
    assert read("instances_per_s", run) == pytest.approx(10 * 2047 / 6.0)
    assert read("setup_s", run) == 9.5
    assert read("peak_mem_gib", run) == 3.0
    assert read("solve_ms_p95", run) == pytest.approx(1e3 * (0.5 + 0.855))


def test_counter_readers():
    run = fake_run()
    assert read("iters_per_instance", run) == 20.0
    assert read("lane_useful_share", run) == pytest.approx(80.0)
    peak = counts.PRODUCT_PEAK_FLOPS[run.config["dtype"]]
    want = (100.0 * 20 * 2048 * 8 * run.config_module.lane_iteration_flops(
        run.config) / (peak * 8 * 0.6))
    assert read("sweep_mfu", run) == pytest.approx(want)


def test_trace_readers():
    run = fake_run()
    assert read("launches_per_iter", run) == pytest.approx(4 / 50)
    assert read("device_idle_share", run) == pytest.approx(50.0)
    flops = sum(run.config_module.call_flops(run.config, 2048, 25)
                for _ in range(2))
    assert read("gemm_roofline", run) == pytest.approx(
        100.0 * flops / (counts.PRODUCT_PEAK_FLOPS[run.config["dtype"]]
                         * 0.8))
    bound = sum(counts.bound_ms(k, counts.RELU_SPECS, run.config["M"],
                                run.config["dtype"], 2048)[0]
                for k in ("pl_forward_message", "pl_backward_message"))
    assert read("pl_message_roofline", run) == pytest.approx(
        100.0 * 1e-3 * bound / 0.2)


def test_readers_find_nothing_without_a_trace_or_a_kernel():
    run = fake_run(timeline=False)
    for name in ("launches_per_iter", "device_idle_share", "gemm_roofline",
                 "pl_message_roofline"):
        assert read(name, run) is None
    run = fake_run(config="cs_glm_f64.lanes2048")
    assert read("pl_message_roofline", run) is None
    run = fake_run()
    run.launches["pl_forward_message"] = 5   # the trace lost some launches
    assert read("pl_message_roofline", run) is None


def test_a_share_is_never_clipped():
    run = fake_run()
    run.timeline.device = [(n, s, s + (e - s) / 1e6)
                           for n, s, e in run.timeline.device]
    assert read("gemm_roofline", run) > 100.0
    assert not math.isnan(read("pl_message_roofline", run))
