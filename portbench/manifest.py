"""What a run needs, found by the names in BENCHMARK.json.

- ``BENCHMARK.json``'s workload gives the cell's configuration and traffic;
- ``configs/<config>.json`` the configuration's sizes and precision, and by
  name (``builder``) the module ``configs/<builder>.py`` that builds it
  through the port and counts its products, and (``reference``) its plain
  reference ``reference/<reference>.py``: configurations of one model in
  two precisions share both;
- ``traffic/<traffic>.json`` the traffic's parameters, whose ``kind`` names
  the loop that drives it (``kinds/<kind>.py``);
- ``cells/<cell>.json`` what belongs to the cell alone: the solver settings
  it overrides, the sample it checks, the limits of the check and the calls
  a traced run profiles;
- ``metrics/<metric>.py`` one reader per metric, for the metrics whose
  ``workloads`` take the cell in (or that have none).

A later change adds a configuration, a traffic, a cell or a metric by adding
such files and an entry in BENCHMARK.json, and edits none of these.
"""
import importlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def read_json(path):
    with open(path) as f:
        return json.load(f)


def benchmark():
    return read_json(ROOT / "BENCHMARK.json")


def applies(metric, workload):
    "Whether a metric of BENCHMARK.json is reported in ``workload``."
    return "workloads" not in metric or workload in metric["workloads"]


def metric_reader(name):
    "The module ``metrics/<name>.py``, loaded by its path."
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Cell:
    """The files of one workload: ``workload``, ``config`` (dict),
    ``config_module``, ``traffic`` (dict), ``kind`` (module), ``cell``
    (dict), ``reference`` (module), and ``metrics``: {"end_to_end" |
    "per_layer": [(entry of BENCHMARK.json, reader module)]}."""

    def __init__(self, name, bench=None):
        bench = bench or benchmark()
        found = [w for w in bench["workloads"] if w["name"] == name]
        if not found:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.workload = found[0]
        entry = [c for c in bench["configs"]
                 if c["name"] == self.workload["config"]][0]
        self.config = read_json(ROOT / entry["file"])
        self.config_module = importlib.import_module(
            f"portbench.configs.{self.config['builder']}")
        self.reference = importlib.import_module(
            f"portbench.reference.{self.config['reference']}")
        self.traffic = read_json(
            HERE / "traffic" / f"{self.workload['traffic']}.json")
        self.kind = importlib.import_module(
            f"portbench.kinds.{self.traffic['kind']}")
        self.cell = read_json(HERE / "cells" / f"{name}.json")
        self.metrics = {
            group: [(m, metric_reader(m["name"])) for m in bench[group]
                    if applies(m, name)]
            for group in ("end_to_end", "per_layer")}
