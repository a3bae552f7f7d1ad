"""Traffic of kind "ep": a closed loop of EP solves through the port's
front door, one caller.

Call i draws ``lanes`` observations on the device from the run's seed and
i (``inputs.observations``), gives them to the student as its ``y``
(``lanes.with_buffers``; one observation without a lane axis when
``lanes`` is 1), solves with ``parallel.dispatch_solver(student)``'s
``solve_info`` and reads back how many lanes converged with finite
posteriors. The next call starts when that read has returned.

For the check, each call keeps a few of its answers on the host: lanes
drawn from the seed and the call, and the lane that ran longest. After the
window a sample of calls drawn from the seed, with the longest lane of all
in it, goes to the configuration's plain reference (``reference/``), which
recomputes the SVD and solves the same observations in float64 until each
lane's own stop rule fires. The program's answers are judged against the
reference's there (``judge``), which holds the solver's stop rule too: an
answer read a step early or late is off by that step.
"""
import numpy as np
import torch

from .. import inputs

#: the numbers compared, each against the cell's limit of the same name
CHECKS = ("r_gap", "v_gap")


class Traffic:
    def __init__(self, run):
        self.run = run
        self.config = run.config
        self.lanes = int(run.traffic["lanes"])
        solver = dict(self.config["solver"])
        solver.update(run.cell.get("solver", {}))
        self.solver_kw = solver
        self.kept = []

    # -- set-up ------------------------------------------------------------
    def setup(self):
        from tramp_tpu_torch.parallel import dispatch_solver
        run, config, spans = self.run, self.config, self.run.spans
        with spans("setup.operator"):
            self.W = inputs.operator(config, run.seed, run.device)
            y0 = inputs.observations(
                config, self.W, inputs.generator(run.device, run.seed,
                                                 inputs.STUDENT), 1)[0]
            run.synchronize()
        with spans("setup.model"):
            self.student, self.likelihood = run.config_module.student(
                config, self.W, y0, run.device)
            self.solver = dispatch_solver(self.student, **self.solver_kw)
            run.synchronize()
        with spans("setup.warm_up"):
            # one solve at the cell's own shapes: builds and loads the
            # kernels and the library handles; its answers are not kept
            ys = self._draw(inputs.generator(run.device, run.seed,
                                             inputs.WARM_UP))
            self.solver.solve_info(self._model(ys))
            run.synchronize()

    # -- one call ----------------------------------------------------------
    def _draw(self, g):
        return inputs.observations(self.config, self.W, g, self.lanes)

    def _model(self, ys):
        from tramp_tpu_torch.parallel import with_buffers
        y = ys if self.lanes > 1 else ys[0]
        return with_buffers(self.student, {(self.likelihood, "y"): y})

    def call(self, i):
        """Call i; returns its record: lanes, loop iterations, the sum of
        the lanes' n_iter, the instances solved, seconds from the solve
        call to the synchronised read."""
        run, spans = self.run, self.run.spans
        with spans("draw"):
            ys = self._draw(inputs.generator(run.device, run.seed,
                                             inputs.CALL, i))
            run.synchronize()
        with spans("build_model"):
            model = self._model(ys)
        with spans("program"):
            t0 = run.clock()
            with spans("solve"):
                post, n_iter, conv = self.solver.solve_info(model)
            with spans("readout"):
                n_iter, conv = n_iter.reshape(-1), conv.reshape(-1)
                finite = torch.stack([
                    torch.isfinite(d["r"].reshape(self.lanes, -1)).all(-1)
                    for d in post.values()]).all(0)
                solved = conv & finite
                self._keep(i, post, n_iter, conv)
                counts = torch.stack([solved.sum(), n_iter.sum(),
                                      n_iter.max()]).tolist()
            seconds = run.clock() - t0
        return {"lanes": self.lanes, "solved": int(counts[0]),
                "n_iter_sum": int(counts[1]), "iterations": int(counts[2]),
                "seconds": seconds}

    def _keep(self, i, post, n_iter, conv):
        """A few answers of call i, copied to the host in one transfer (on
        the device they would raise the peak memory with every call): lanes
        drawn from the seed and i, and the lane with the most iterations."""
        run = self.run
        picks = int(run.cell["check"]["lanes_per_call"])
        if self.lanes == 1:
            idx = torch.zeros(1, dtype=torch.int64, device=n_iter.device)
        else:
            g = np.random.default_rng(
                inputs.stream_seed(run.seed, inputs.SAMPLE, i))
            drawn = torch.as_tensor(g.choice(self.lanes, picks - 1,
                                             replace=False),
                                    device=n_iter.device)
            idx = torch.cat([drawn, n_iter.argmax().reshape(1)])
        columns = [n_iter[idx, None], conv[idx, None]]
        for d in post.values():
            columns += [d["r"].reshape(self.lanes, -1)[idx],
                        d["v"].reshape(self.lanes, 1)[idx]]
        host = torch.cat([c.double() for c in columns], 1).cpu()
        rows, at = {}, 2
        for vid, d in post.items():
            n = d["r"][0].numel() if self.lanes > 1 else d["r"].numel()
            rows[vid] = {"r": host[:, at:at + n], "v": host[:, at + n]}
            at += n + 1
        self.kept.append((i, idx.cpu(), rows, host[:, 0].long(),
                          host[:, 1].bool()))

    def close(self):
        "Free the program's state: the solver and the student."
        self.solver = self.student = None

    # -- the check ---------------------------------------------------------
    def sample(self):
        """The kept answers of the calls drawn from the seed (the cell's
        ``check.calls``), with the call that holds the longest lane:
        (call ids, lane ids, answers, n_iter, conv), all on the host."""
        run = self.run
        count = min(int(run.cell["check"]["calls"]), len(self.kept))
        longest = max(range(len(self.kept)),
                      key=lambda j: int(self.kept[j][3].max()))
        g = np.random.default_rng(inputs.stream_seed(run.seed, inputs.SAMPLE))
        others = [j for j in range(len(self.kept)) if j != longest]
        chosen = [longest] + sorted(
            g.choice(others, count - 1, replace=False).tolist()
            if count > 1 else [])
        calls, lanes, n_iter, conv = [], [], [], []
        rows = {}
        for j in chosen:
            i, idx, r, n, c = self.kept[j]
            calls += [i] * len(idx)
            lanes += idx.tolist()
            n_iter.append(n)
            conv.append(c)
            for vid, d in r.items():
                rows.setdefault(vid, {"r": [], "v": []})
                rows[vid]["r"].append(d["r"])
                rows[vid]["v"].append(d["v"])
        answers = {vid: {k: torch.cat(v) for k, v in d.items()}
                   for vid, d in rows.items()}
        return calls, lanes, answers, torch.cat(n_iter), torch.cat(conv)

    def inputs_of(self, calls, lanes):
        "The observations of (call, lane) pairs, drawn again from the seed."
        run = self.run
        ys = {}
        for i in sorted(set(calls)):
            ys[i] = self._draw(inputs.generator(run.device, run.seed,
                                                inputs.CALL, i))
        return torch.stack([ys[i][lane] for i, lane in zip(calls, lanes)])

    def check(self):
        """The numbers compared: [(name, value)]. The reference runs on the
        kept sample once the window is over and the program is freed."""
        run = self.run
        calls, lanes, answers, n_iter, conv = self.sample()
        ys = self.inputs_of(calls, lanes)
        ref, stop, _ = run.reference.solve(self.config, self.W, ys,
                                           **reference_kw(self.solver_kw))
        run.note(f"check: {len(calls)} instances of calls "
                 f"{sorted(set(calls))}; program n_iter {n_iter.tolist()}, "
                 f"conv {conv.int().tolist()}; reference n_iter "
                 f"{stop.tolist()}")
        return judge(answers, ref)


def reference_kw(solver_kw):
    "The solver's settings as the reference takes them."
    kw = {"tol": solver_kw["tol"], "max_iter": solver_kw["max_iter"]}
    if solver_kw.get("damping"):
        kw["damping"] = solver_kw["damping"]
    return kw


def judge(answers, ref):
    """The numbers of ``CHECKS`` for answers judged against the reference's,
    over every instance and variable:

    - r_gap: the largest |r - r_ref| of an instance's posterior mean, over
      its largest |r_ref|;
    - v_gap: the largest |v - v_ref| / v_ref of a posterior variance.
    A NaN anywhere makes its number NaN, which no limit passes."""
    r_gap = v_gap = 0.0
    for vid, want in ref.items():
        got = answers[vid]
        r_want = want["r"].double().cpu()
        r = got["r"].double().cpu().reshape(r_want.shape)
        r_gap = _worst(r_gap, ((r - r_want).abs().amax(-1)
                               / r_want.abs().amax(-1)))
        v_want = want["v"].double().cpu()
        v = got["v"].double().cpu().reshape(v_want.shape)
        v_gap = _worst(v_gap, (v - v_want).abs() / v_want.abs())
    return [("r_gap", r_gap), ("v_gap", v_gap)]


def _worst(so_far, values):
    "The larger of ``so_far`` and ``values``' largest, NaN if one is NaN."
    return float(np.max(np.append(values.numpy(), so_far)))
