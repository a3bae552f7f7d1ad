"""BENCHMARK.json's names, units and references, and the files the harness
finds by those names."""
import re

import pytest

from portbench.tests.helpers import ROOT
from portbench import manifest
from portbench.kinds import ep

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = manifest.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]

#: the names, units and cells the benchmark was defined with
END_TO_END = {"instances_per_s": "instances/s", "solve_ms_p95": "ms",
              "peak_mem_gib": "GiB", "setup_s": "s"}
PER_LAYER = {"iters_per_instance": "iterations", "lane_useful_share": "%",
             "launches_per_iter": "launches", "pl_message_roofline": "%",
             "gemm_roofline": "%", "device_idle_share": "%",
             "sweep_mfu": "%"}


def test_keys_and_limits_of_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    names = [m["name"] for group in ("end_to_end", "per_layer")
             for m in BENCH[group]]
    names += [c["name"] for c in BENCH["configs"]] + CELLS
    assert len(names) == len(set(names))
    for name in names:
        assert NAME.match(name), name


def test_metrics_names_units_and_moves():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    per_layer = {m["name"]: m for m in BENCH["per_layer"]}
    assert {n: m["unit"] for n, m in e2e.items()} == END_TO_END
    assert {n: m["unit"] for n, m in per_layer.items()} == PER_LAYER
    for m in e2e.values():
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in per_layer.values():
        assert m["moves"] == "instances_per_s"
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert UNIT.match(m["unit"]) and "\n" not in m["layer"]


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reports_what_the_contract_asks(cell):
    e2e = [m["name"] for m in BENCH["end_to_end"]
           if manifest.applies(m, cell)]
    per_layer = [m for m in BENCH["per_layer"] if manifest.applies(m, cell)]
    assert "setup_s" in e2e and "instances_per_s" in e2e
    assert per_layer and all(m["moves"] in e2e for m in per_layer)
    workload = [w for w in BENCH["workloads"] if w["name"] == cell][0]
    assert workload["chips"] == 1
    assert cell == f"{workload['config']}.{workload['traffic']}"
    assert len(workload["why"]) <= 200


@pytest.mark.parametrize("cell", CELLS)
def test_files_are_found_by_name(cell):
    found = manifest.Cell(cell)
    assert found.config["name"] == found.workload["config"]
    assert set(found.cell["limits"]) == set(ep.CHECKS)
    assert found.kind.Traffic and found.reference.solve
    for group in ("end_to_end", "per_layer"):
        for entry, reader in found.metrics[group]:
            assert callable(reader.read), entry["name"]


def test_every_configuration_has_a_cell_and_a_file_of_its_own():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used and c["reduced"] == []
        assert c["file"].startswith("portbench/")
        assert manifest.read_json(ROOT / c["file"])["name"] == c["name"]


def test_every_metric_file_is_listed_and_every_listed_metric_has_one():
    listed = {m["name"] for g in ("end_to_end", "per_layer")
              for m in BENCH[g]}
    files = {p.stem for p in (manifest.HERE / "metrics").glob("*.py")
             if p.stem != "__init__"}
    assert files == listed
