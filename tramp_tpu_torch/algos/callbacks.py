"""Callbacks of the Python-loop iterate path (``iterate(callback=...)``).
Counterpart of tramp_tpu/algos/callbacks.py.

The loop without a callback already stops early and rolls back inside
``iterate``; an ``EarlyStopping`` / ``EarlyStoppingEP`` passed as
``early_stop=`` only hands that loop its parameters. As a ``callback=`` the
same object is called after every sweep, like the others here, which track
and log. ``get_dataframe`` needs pandas, imported there."""
import logging

import numpy as np
import torch

from .metrics import METRICS

logger = logging.getLogger(__name__)


def _mean(x):
    return float(torch.as_tensor(x).double().mean())


def _numpy(x):
    return torch.as_tensor(x).detach().cpu().numpy()


def _dataframe(records):
    import pandas as pd
    return pd.DataFrame(records)


class Callback:
    def __repr__(self):
        return type(self).__name__


class PassCallback(Callback):
    def __call__(self, algo, i, max_iter):
        pass


class JoinCallback(Callback):
    def __init__(self, callbacks):
        self.callbacks = callbacks

    def __call__(self, algo, i, max_iter):
        stops = [cb(algo, i, max_iter) for cb in self.callbacks]
        return any(bool(s) for s in stops)


class LogProgress(Callback):
    def __init__(self, ids="all", every=1):
        self.ids = ids
        self.every = every

    def __call__(self, algo, i, max_iter):
        if i % self.every == 0:
            data = algo.get_variables_data(self.ids)
            logger.info(f"iteration={i + 1}/{max_iter}")
            for id, d in data.items():
                logger.info(f"id={id} v={_mean(d['v']):.3f}")


class TrackMessages(Callback):
    def __init__(self, keys=["a"]):
        self.keys = keys
        self.records = []

    def __call__(self, algo, i, max_iter):
        if i == 0:
            self.records = []
        for rec in algo.get_edges_data(self.keys):
            rec["iter"] = i
            self.records.append(rec)

    def get_dataframe(self):
        return _dataframe(self.records)


class TrackObjective(Callback):
    def __init__(self):
        self.model_records = []

    def __call__(self, algo, i, max_iter):
        if i == 0:
            self.model_records = []
        A = algo.update_objective()
        self.model_records.append(dict(A=float(A), n_iter=algo.n_iter))

    def get_dataframe(self):
        return _dataframe(self.model_records)


class TrackEvolution(Callback):
    def __init__(self, ids="all", every=1, verbose=False):
        self.ids = ids
        self.every = every
        self.verbose = verbose
        self.records = []

    def __call__(self, algo, i, max_iter):
        if i == 0:
            self.records = []
        if i % self.every == 0:
            for id, data in algo.get_variables_data(self.ids).items():
                record = dict(id=id, v=_mean(data["v"]), iter=i)
                self.records.append(record)
                if self.verbose:
                    print(record)

    def get_dataframe(self):
        return _dataframe(self.records)


class TrackEstimate(Callback):
    def __init__(self, ids="all", every=1):
        self.ids = ids
        self.every = every
        self.records = []

    def __call__(self, algo, i, max_iter):
        if i == 0:
            self.records = []
        if i % self.every == 0:
            for id, data in algo.get_variables_data(self.ids).items():
                self.records.append(
                    dict(id=id, r=_numpy(data["r"]), iter=i))

    def get_dataframe(self):
        return _dataframe(self.records)


class TrackErrors(Callback):
    def __init__(self, true_values, metrics=["mse"], every=1, verbose=False):
        self.ids = list(true_values.keys())
        self.metrics = metrics
        self.every = every
        self.X_true = true_values
        self.verbose = verbose
        self.errors = []

    def __call__(self, algo, i, max_iter):
        if i == 0:
            self.errors = []
        if i % self.every == 0:
            data = algo.get_variables_data(self.ids)
            for id in self.ids:
                error = dict(id=id, iter=i)
                for metric in self.metrics:
                    error[metric] = METRICS[metric](
                        self.X_true[id], data[id]["r"])
                self.errors.append(error)
            if self.verbose:
                print(self.errors[-len(self.ids):])

    def get_dataframe(self):
        return _dataframe(self.errors)


class TrackOverlaps(Callback):
    def __init__(self, true_values, ids="all", every=1, verbose=False):
        self.ids = ids
        self.every = every
        self.X_true = true_values
        self.verbose = verbose
        self.records = []

    def __call__(self, algo, i, max_iter):
        if i == 0:
            self.records = []
        if i % self.every == 0:
            for id, data in algo.get_variables_data(self.ids).items():
                x0 = _numpy(self.X_true[id]).astype(np.float64)
                r = _numpy(data["r"]).astype(np.float64)
                n = x0.shape[0]
                record = dict(
                    id=id, m=float(r.T @ x0) / n, q=float(r.T @ r) / n,
                    Q=float(x0.T @ x0) / n, iter=i)
                self.records.append(record)
                if self.verbose:
                    print(record)

    def get_dataframe(self):
        return _dataframe(self.records)


class EarlyStopping(Callback):
    """Stop when the posterior variances change by less than ``tol``; roll
    back and stop when one grows by more than ``max_increase`` after
    ``wait_increase`` iterations. Reference callbacks.py:195-243."""

    kind = "v"

    def __init__(self, ids="all", tol=1e-6, min_variance=-1,
                 wait_increase=5, max_increase=0.2):
        self.ids = ids
        self.tol = tol
        self.min_variance = min_variance
        self.wait_increase = wait_increase
        self.max_increase = max_increase
        self.old_vs = None
        self.old_state = None

    def __call__(self, algo, i, max_iter):
        if i == 0:
            self.old_vs = None
        data = algo.get_variables_data(self.ids)
        new_vs = [_mean(d["v"]) for d in data.values()]
        if any(v < self.min_variance for v in new_vs):
            logger.info(f"early stopping min variance {min(new_vs)}")
            return True
        if any(np.isnan(v) for v in new_vs):
            logger.warning("early stopping nan values; restoring state")
            if self.old_state is not None:
                algo.state = self.old_state
            return True
        if self.old_vs:
            tols = [abs(o - n) for o, n in zip(self.old_vs, new_vs)]
            if max(tols) < self.tol:
                return True
            increase = [n - o for o, n in zip(self.old_vs, new_vs)]
            if i > self.wait_increase and max(increase) > self.max_increase:
                logger.info("divergence detected; restoring state")
                if self.old_state is not None:
                    algo.state = self.old_state
                return True
        self.old_vs = new_vs
        self.old_state = algo.state


def _norm(x):
    return float(torch.sqrt(torch.mean(x.double() ** 2)))


class EarlyStoppingEP(Callback):
    """The same on the relative change of the posterior means.
    Reference callbacks.py:250-286."""

    kind = "r"

    def __init__(self, ids="all", tol=1e-6, wait_increase=5, max_increase=0.2):
        self.ids = ids
        self.tol = tol
        self.wait_increase = wait_increase
        self.max_increase = max_increase
        self.old_rs = None
        self.old_state = None

    def __call__(self, algo, i, max_iter):
        if i == 0:
            self.old_rs = None
        data = algo.get_variables_data(self.ids)
        new_rs = [d["r"] for d in data.values()]
        if self.old_rs is not None:
            tols = [_norm(n - o) / max(_norm(n), 1e-300)
                    for o, n in zip(self.old_rs, new_rs)]
            if max(tols) < self.tol:
                return True
            if i > self.wait_increase and max(tols) > self.max_increase:
                logger.info("increase above max_increase; restoring state")
                if self.old_state is not None:
                    algo.state = self.old_state
                return True
        self.old_rs = new_rs
        self.old_state = algo.state
