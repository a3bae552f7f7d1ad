"""The control of each cell's check, on the card at the cell's own size:
the plain reference in the precision below the configuration's (float32
for float64, TF32 products for float32) must fail the check on every seed,
where the benchmark's sound runs pass it. On the chip, from the root of a
checkout:

    python -m pytest --noconftest -p no:cacheprovider -m cuda portbench/tests
"""
import pytest

from portbench import manifest
from portbench.control import control_readings

CELLS = [w["name"] for w in manifest.benchmark()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_the_control_fails_the_check(workload):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cell = manifest.Cell(workload)
    limits = cell.cell["limits"]
    for seed in (101, 2**33 + 5, 3_000_000_123):
        numbers, _, _ = control_readings(cell, seed, "cuda")
        assert any(not value <= limits[name] for name, value in numbers), (
            seed, numbers)
