"""Traffic of kind "se": a closed loop of State Evolution phase grids
through the port's front door (``tramp_tpu_torch.parallel``'s
``build_se_grid``, ``solve_se_grid``, ``se_grid_records``), one caller.

Call i draws its grid on the host from the run's seed and i: the
configuration's alpha axis, each alpha moved by a uniform draw in
[-jitter, jitter) (``inputs.stream_seed(seed, CALL, i)``), with the golden
alphas unmoved, times the rho axis. The harness's ``build_model`` span holds
the grid's build (the points' models, the stacked lanes, the solver),
``solve`` the port's one batched solve and nothing else, and ``readout``
the records read back to the host. A point is solved when its SE stopped by
its own rule before ``max_iter`` (the |dv| stop or the rollback) with a
finite v > 0. The next call starts when the records are read.

Each call keeps every point's (alpha, rho, v, n_iter) on the host. After
the window the calls drawn from the seed, with the call that holds the
longest point, go to the configuration's plain reference
(``reference/cs_glm_se.py``), which runs the same SE recursion in float64
on the CPU, each point to its own stop (``judge``); each golden row is
compared with its pinned value too.
"""
import numpy as np

from .. import inputs

#: the numbers compared, each against the cell's limit of the same name
CHECKS = ("v_gap", "golden_gap")
#: the floors under which v_gap is printed beside the one compared
FLOORS = (0.0, 1e-10, 1e-9, 1e-8, 1e-7, 1e-6, 1e-5)


def _nodes_evaluated():
    """The port's count of integrand evaluations (``utils.integration``),
    None where the program has none."""
    from tramp_tpu_torch.utils import integration
    return getattr(integration, "nodes_evaluated", None)


class Traffic:
    def __init__(self, run):
        self.run = run
        self.config = run.config
        solver = dict(self.config["solver"])
        solver.update(run.cell.get("solver", {}))
        self.solver_kw = solver
        self.rhos = run.config_module.axis(self.config["rhos"])
        self.kept = []

    # -- set-up ------------------------------------------------------------
    def setup(self):
        from tramp_tpu_torch import parallel
        self.parallel = parallel
        run = self.run
        self.builder, self.model_kw = run.config_module.point_builder(
            self.config)
        with run.spans("setup.warm_up"):
            # one grid from the warm-up stream: the first solve's set-up on
            # the device; its answers are not kept
            grid = self._build(self._alphas(inputs.WARM_UP))
            parallel.se_grid_records(grid, *parallel.solve_se_grid(grid))
            run.synchronize()

    # -- one call ----------------------------------------------------------
    def _alphas(self, *path):
        run = self.run
        return grid_alphas(self.config, run.config_module, run.traffic,
                           inputs.stream_seed(run.seed, *path))

    def _build(self, alphas):
        import torch
        kw = self.solver_kw
        return self.parallel.build_se_grid(
            self.builder, {"alpha": alphas, "prior_rho": self.rhos},
            ids=("x",), a0=self.config["a0"], max_iter=kw["max_iter"],
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
            nodes = _nodes_evaluated()
            with spans("solve"):
                post, n_iter = self.parallel.solve_se_grid(grid)
            after = _nodes_evaluated()
            with spans("readout"):
                records = self.parallel.se_grid_records(grid, post, n_iter)
            seconds = run.clock() - t0
        v = np.array([r["v"] for r in records])
        n = np.array([r["n_iter"] for r in records])
        solved = (n < self.solver_kw["max_iter"]) & np.isfinite(v) & (v > 0)
        self.kept.append((i, np.array([r["alpha"] for r in records]),
                          np.array([r["prior_rho"] for r in records]), v, n))
        return {"lanes": len(records), "solved": int(solved.sum()),
                "n_iter_sum": int(n.sum()), "iterations": int(n.max()),
                "seconds": seconds,
                "quad_nodes": None if nodes is None else after - nodes}

    def close(self):
        "Nothing outlives a call: each builds its own grid and solver."

    # -- the check ---------------------------------------------------------
    def sample(self):
        """The kept answers of the calls drawn from the seed (the cell's
        ``check.calls``), with the call that holds the longest point:
        (call ids, alphas, rhos, v, n_iter), each point's, on the host."""
        run = self.run
        count = min(int(run.cell["check"]["calls"]), len(self.kept))
        longest = max(range(len(self.kept)),
                      key=lambda j: int(self.kept[j][4].max()))
        g = np.random.default_rng(inputs.stream_seed(run.seed, inputs.SAMPLE))
        others = [j for j in range(len(self.kept)) if j != longest]
        chosen = [longest] + sorted(
            g.choice(others, count - 1, replace=False).tolist()
            if count > 1 else [])
        calls = [self.kept[j][0] for j in chosen]
        return (calls,) + tuple(np.concatenate([self.kept[j][k]
                                                for j in chosen])
                                for k in range(1, 5))

    def check(self):
        """The numbers compared: [(name, value)]. The reference runs on the
        CPU once the window is over."""
        run = self.run
        calls, alphas, rhos, v, n_iter = self.sample()
        kw = self.solver_kw
        v_ref, n_ref, _ = run.reference.solve(
            self.config, alphas, rhos, kw["tol"], kw["max_iter"])
        v_ref, n_ref = v_ref.numpy(), n_ref.numpy()
        v, n_iter = v.astype(float), n_iter.astype(int)
        off = np.nonzero(n_iter != n_ref)[0]
        run.note(f"check: {len(v)} points of calls {calls}; n_iter "
                 f"{int(n_iter.min())} to {int(n_iter.max())}, mean "
                 f"{n_iter.mean():.4f}, {len(off)} points off the "
                 "reference's n_iter" + "".join(
                     f"; alpha {float(alphas[k])!r} rho {float(rhos[k])!r}: "
                     f"{int(n_iter[k])} against {int(n_ref[k])}"
                     for k in off[:10]))
        gap = np.abs(v - v_ref) / v_ref
        run.note("check: v_gap by v_floor: " + ", ".join(
            f"{floor:g}: {judge(v, v_ref, floor, [])[0][1]!r}"
            for floor in FLOORS))
        for k in np.argsort(-gap)[:3]:
            run.note(f"check: |v - v_ref| / v_ref {float(gap[k])!r} at "
                     f"alpha {float(alphas[k])!r} rho {float(rhos[k])!r}: v "
                     f"{float(v[k])!r}, reference {float(v_ref[k])!r}, "
                     f"n_iter {int(n_iter[k])}")
        golden = golden_rows(self.config, alphas, rhos, v, v_ref)
        rho = self.config["golden_rows"]["rho"]
        for alpha, got, ref, pinned, rtol in golden:
            run.note(f"check: golden alpha {alpha!r} rho {rho}: v {got!r}, "
                     f"reference {ref!r}, pinned {pinned!r} (rtol {rtol})")
        floor = float(run.cell["check"]["v_floor"])
        return judge(v, v_ref, floor, golden)


def grid_alphas(config, config_module, traffic, seed):
    """The alphas of the grid drawn from the stream seeded ``seed``: the
    configuration's axis, each alpha moved by a uniform draw in [-jitter,
    jitter), and the golden alphas (``config_module.alphas``)."""
    jitter = float(traffic["jitter"])
    shift = np.random.default_rng(seed).uniform(-jitter, jitter,
                                                config["alphas"]["num"])
    return config_module.alphas(config, shift)


def golden_rows(config, alphas, rhos, v, v_ref):
    """[(alpha, v, v_ref, pinned v, rtol)] of every sampled point on a
    golden row of the configuration."""
    rows = config["golden_rows"]
    out = []
    for alpha, pinned, rtol in rows["rows"]:
        at = np.nonzero((alphas == alpha) & (np.abs(rhos - rows["rho"])
                                             < 1e-12))[0]
        out += [(alpha, float(v[k]), float(v_ref[k]), pinned, rtol)
                for k in at]
    return out


def judge(v, v_ref, floor, golden):
    """The numbers of ``CHECKS``:

    - v_gap: the largest |v - v_ref| / max(v_ref, floor) over the points;
    - golden_gap: the largest |v - pinned| / (rtol pinned) over the golden
      rows' points (none sampled: infinite).
    A NaN anywhere makes its number NaN, which no limit passes."""
    v_gap = float(np.max(np.abs(v - v_ref) / np.maximum(v_ref, floor)))
    golden_gap = float(np.max([abs(got - pinned) / (rtol * pinned)
                               for _, got, _, pinned, rtol in golden]
                              or [np.inf]))
    return [("v_gap", v_gap), ("golden_gap", golden_gap)]
