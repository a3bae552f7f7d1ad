"""What the benchmark's CPU tests share: a small run of a cell on the CPU
in float64, through the harness's own entry point."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: the cells' sizes cut for the CPU: float64, so that sound runs read at
#: rounding and every fault stands out
SMALL = {"config": {"N": 200, "M": 100, "dtype": "float64"}}


def small_run(workload, seed=3_000_000_019, seconds=0.3, trace=0, lanes=8):
    """``run.main`` on the CPU at ``SMALL`` sizes; returns its result."""
    from portbench import manifest, run
    cell = manifest.Cell(workload)
    traffic_lanes = lanes if int(cell.traffic["lanes"]) > 1 else 1
    overrides = dict(SMALL, traffic={"lanes": traffic_lanes}, cell={
        "check": {"calls": 2, "lanes_per_call": min(3, traffic_lanes)}})
    return run.main(["--workload", workload, "--seed", str(seed),
                     "--seconds", str(seconds), "--trace", str(trace)],
                    device="cpu", overrides=overrides)
