"""Traffic of kind "se_ids": kind "se"'s closed loop of State Evolution
phase grids (``kinds/se.py``: the front door's three steps, the grid
drawn on the host from the seed and the call, the harness's spans), for a
configuration that reports several variables (its ``ids``) and pins no
golden rows.

A call's lanes are its grid points. A point is solved when its SE stopped
by its own rule before ``max_iter`` with a finite v > 0 for every id; its
n_iter is counted once. Each call keeps every point's (alpha, rho, v of
each id, n_iter) on the host. After the window the calls drawn from the
seed, with the call that holds the longest point, go to the
configuration's plain reference one call's points at a time, on the run's
device once the program is freed: it runs the same SE recursion in
float64, each point to its own stop. The check compares v of every id
(``judge``); each n_iter off the reference's is printed, not compared.
"""
import numpy as np

from .. import inputs
from . import se

#: the numbers compared, each against the cell's limit of the same name
CHECKS = ("v_gap",)


class Traffic(se.Traffic):
    def __init__(self, run):
        super().__init__(run)
        self.ids = tuple(self.config["ids"])

    def _build(self, alphas):
        import torch
        kw = self.solver_kw
        return self.parallel.build_se_grid(
            self.builder, {"alpha": alphas, "prior_rho": self.rhos},
            ids=self.ids, a0=self.config["a0"], max_iter=kw["max_iter"],
            tol=kw["tol"], damping=kw["damping"], device=self.run.device,
            dtype=getattr(torch, self.config["dtype"]), **self.model_kw)

    def call(self, i):
        """Call i; returns its record: lanes (points), the points solved,
        the sum of their n_iter, the loop's iterations, seconds from the
        solve call to the records, and the integrand evaluations of the
        solve (None where the program does not count them)."""
        run, spans = self.run, self.run.spans
        with spans("draw"):
            alphas = self._alphas(inputs.CALL, i)
        with spans("build_model"):
            grid = self._build(alphas)
        with spans("program"):
            t0 = run.clock()
            nodes = se._nodes_evaluated()
            with spans("solve"):
                post, n_iter = self.parallel.solve_se_grid(grid)
            after = se._nodes_evaluated()
            with spans("readout"):
                records = self.parallel.se_grid_records(grid, post, n_iter)
            seconds = run.clock() - t0
        points = len(records) // len(self.ids)
        # records run over the ids, each over the points
        v = np.array([r["v"] for r in records]).reshape(len(self.ids),
                                                        points).T
        n = np.array([r["n_iter"] for r in records[:points]])
        solved = ((n < self.solver_kw["max_iter"])
                  & np.isfinite(v).all(1) & (v > 0).all(1))
        self.kept.append((i, np.array([r["alpha"] for r in records[:points]]),
                          np.array([r["prior_rho"]
                                    for r in records[:points]]), v, n))
        return {"lanes": points, "solved": int(solved.sum()),
                "n_iter_sum": int(n.sum()), "iterations": int(n.max()),
                "seconds": seconds,
                "quad_nodes": None if nodes is None else after - nodes}

    def check(self):
        """The numbers compared: [(name, value)]. The reference runs on the
        run's device, one call's points at a time."""
        run = self.run
        calls, alphas, rhos, v, n_iter = self.sample()
        kw = self.solver_kw
        v_ref, n_ref = [], []
        for block in np.split(np.arange(len(n_iter)), len(calls)):
            got, n, _ = run.reference.solve(
                self.config, alphas[block], rhos[block], kw["tol"],
                kw["max_iter"], device=run.device)
            v_ref.append(got.cpu().numpy())
            n_ref.append(n.cpu().numpy())
        v_ref, n_ref = np.concatenate(v_ref), np.concatenate(n_ref)
        v, n_iter = v.astype(float), n_iter.astype(int)
        off = np.nonzero(n_iter != n_ref)[0]
        run.note(f"check: {len(n_iter)} points of calls {calls}; n_iter "
                 f"{int(n_iter.min())} to {int(n_iter.max())}, mean "
                 f"{n_iter.mean():.4f}, {len(off)} points off the "
                 "reference's n_iter" + "".join(
                     f"; alpha {float(alphas[k])!r} rho {float(rhos[k])!r}: "
                     f"{int(n_iter[k])} against {int(n_ref[k])}"
                     for k in off[:10]))
        run.note("check: v_gap by v_floor: " + ", ".join(
            f"{floor:g}: {judge(v, v_ref, floor)[0][1]!r}"
            for floor in se.FLOORS))
        gap = np.abs(v - v_ref) / v_ref
        for k in np.argsort(-gap.max(1))[:3]:
            run.note(f"check: |v - v_ref| / v_ref {gap[k].tolist()!r} "
                     f"({', '.join(self.ids)}) at alpha {float(alphas[k])!r} "
                     f"rho {float(rhos[k])!r}: v {v[k].tolist()!r}, "
                     f"reference {v_ref[k].tolist()!r}, n_iter "
                     f"{int(n_iter[k])}")
        return judge(v, v_ref, float(run.cell["check"]["v_floor"]))


def judge(v, v_ref, floor):
    """The numbers of ``CHECKS``: v_gap, the largest |v - v_ref| /
    max(v_ref, floor) over the points and ids. A NaN anywhere makes it NaN,
    which no limit passes."""
    return [("v_gap", float(np.max(np.abs(v - v_ref)
                                   / np.maximum(v_ref, floor))))]
