"""Grid sweeps. Counterpart of tramp_tpu/experiments/multiple_experiments.py.

The sequential loop is kept for API parity; the batched path lives in
tramp_tpu_torch.parallel. The functions that return a DataFrame import
pandas when called."""
import itertools
import logging

import numpy as np

logger = logging.getLogger(__name__)


def log_on_progress(i, total):
    logger.info(f"experiment {i}/{total}")


def as_list(x):
    if isinstance(x, list):
        return x
    if isinstance(x, np.ndarray):
        return list(x)
    return [x]


def get_experiments_from_kwargs(**kwargs):
    coerced = {key: as_list(val) for key, val in kwargs.items()}
    return [
        dict(zip(coerced.keys(), values))
        for values in itertools.product(*coerced.values())
    ]


def _records(run, experiment):
    results = run(**experiment)
    if isinstance(results, dict):
        results = [results]
    for result in results:
        result.update(experiment)
    return results


def run_experiments(run, on_progress=None, **kwargs):
    import pandas as pd
    on_progress = on_progress or log_on_progress
    experiments = get_experiments_from_kwargs(**kwargs)
    records = []
    for idx, experiment in enumerate(experiments):
        try:
            records += _records(run, experiment)
        except Exception as e:
            logger.error(f"Experiment {experiment} failed\n{e}")
        on_progress(idx + 1, len(experiments))
    return pd.DataFrame(records)


def simple_run_experiments(run, **kwargs):
    "Same as run_experiments but raises on error."
    import pandas as pd
    records = []
    for experiment in get_experiments_from_kwargs(**kwargs):
        records += _records(run, experiment)
    return pd.DataFrame(records)


def save_experiments(run, csv_file, on_progress=None, **kwargs):
    df = run_experiments(run, on_progress, **kwargs)
    df.to_csv(csv_file, index=False)
    return df
