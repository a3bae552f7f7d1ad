"""The control of the relu SE cell's check: the plain relu SE reference
(``reference/relu_se.py``) computed in float32, the precision just below
the configuration's float64, judged against the float64 reference by the
number and limit the benchmark's runs use (``kinds/se_ids.py``'s
``judge``). The check is sound only if the control fails it.

    python3 portbench/control_relu_se.py --workload relu_se.lanes1024 \\
        --seeds 11,12,13 [--device cuda]

Per seed the grids of as many calls as a run samples (calls 0, 1, ...),
drawn as the run draws them, one call's points at a time. Prints, per seed,
the number beside its limit, and a last JSON line with the readings. The
benchmark's runs do not run it; portbench/tests/test_portbench_relu_se.py
does, on the card.
"""
import argparse
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import manifest  # noqa: E402
from portbench.control_se import grid_points  # noqa: E402
from portbench.kinds.se import FLOORS  # noqa: E402
from portbench.kinds.se_ids import judge  # noqa: E402


def control_readings(cell, seed, device="cpu"):
    """The numbers the cell compares, for the control on ``seed``:
    [(name, value)], the control's and the reference's n_iter, and
    {floor: v_gap} under each of ``FLOORS``."""
    import torch
    config = cell.config
    calls = int(cell.cell["check"]["calls"])
    alphas, rhos = grid_points(cell, seed, calls)
    solver = dict(config["solver"])
    solver.update(cell.cell.get("solver", {}))
    kw = dict(tol=solver["tol"], max_iter=solver["max_iter"], device=device)
    out = {"got": [], "got_n": [], "want": [], "want_n": []}
    for block in np.split(np.arange(len(alphas)), calls):
        for key, dtype in (("got", torch.float32), ("want", torch.float64)):
            v, n, _ = cell.reference.solve(config, alphas[block],
                                           rhos[block], dtype=dtype, **kw)
            out[key].append(v.double().cpu().numpy())
            out[key + "_n"].append(n.cpu().numpy())
    got, got_n, want, want_n = (np.concatenate(out[k]) for k in
                                ("got", "got_n", "want", "want_n"))
    numbers = judge(got, want, float(cell.cell["check"]["v_floor"]))
    by_floor = {floor: judge(got, want, floor)[0][1] for floor in FLOORS}
    return numbers, got_n, want_n, by_floor


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True,
                        help="comma-separated seeds")
    parser.add_argument("--device", default="cpu")
    args = parser.parse_args(argv)
    cell = manifest.Cell(args.workload)
    limits = cell.cell["limits"]
    out = {}
    for seed in (int(s) for s in args.seeds.split(",")):
        numbers, got_n, want_n, by_floor = control_readings(
            cell, seed, args.device)
        out[seed] = dict(numbers)
        off = int((got_n != want_n).sum())
        print(f"control {args.workload} seed {seed}: "
              + ", ".join(f"{name} {value!r} (limit {limits[name]!r}, "
                          f"{'passes' if value <= limits[name] else 'fails'})"
                          for name, value in numbers)
              + f"; n_iter off the reference's at {off} of {len(got_n)} "
              "points; v_gap by v_floor: " + ", ".join(
                  f"{floor:g}: {value!r}"
                  for floor, value in by_floor.items()), flush=True)
    print(json.dumps({"workload": args.workload, "device": args.device,
                      "control": out}))


if __name__ == "__main__":
    main()
