"""Teacher-student scenarios. Counterpart of
tramp_tpu/experiments/teacher_student_scenario.py."""
import logging

import torch

from ..algos.metrics import METRICS
from ..models import Model
from ..algos import (
    TrackErrors, TrackEvolution, JoinCallback,
    ExpectationPropagation, StateEvolution,
)

logger = logging.getLogger(__name__)


def _scalar(v):
    return float(torch.as_tensor(v).double().mean())


class TeacherStudentScenario:
    """Teacher generates data; student infers.

    Parameters (reference l:10-33): teacher/student models, x_ids to infer,
    y_ids observed."""

    def __init__(self, teacher, student, x_ids=["x"], y_ids=["y"]):
        if not isinstance(student, Model):
            raise ValueError("student not a Model")
        if not hasattr(teacher, "sample"):
            raise ValueError("teacher does not have a .sample() method")
        sample = teacher.sample()
        for x_id in x_ids:
            if x_id not in student.variable_ids:
                raise ValueError(f"x_id = {x_id} not in student variable_ids")
            if x_id not in sample:
                raise ValueError(f"x_id = {x_id} not in teacher variable_ids")
        for y_id in y_ids:
            if y_id not in student.variable_ids:
                raise ValueError(f"y_id = {y_id} not in student variable_ids")
            if y_id not in sample:
                raise ValueError(f"y_id = {y_id} not in teacher variable_ids")
        self.x_ids = x_ids
        self.y_ids = y_ids
        self.teacher = teacher
        self.generative_student = student
        self._device = next(iter(sample.values())).device

    def setup(self, seed=0):
        generator = torch.Generator(device=self._device).manual_seed(seed)
        sample = self.teacher.sample(generator)
        self.true_values = sample
        self.x_true = {x_id: sample[x_id] for x_id in self.x_ids}
        self.observations = {y_id: sample[y_id] for y_id in self.y_ids}
        self.student = self.generative_student.to_observed(self.observations)

    def run_all(self, source="EP,SE", metrics=["mse"], seed=0, **algo_kwargs):
        self.setup(seed)
        records = []
        if "SE" in source:
            x_data = self.run_se(**algo_kwargs)
            records += [
                dict(source="SE", x_id=x_id,
                     v=_scalar(x_data[x_id]["v"]), n_iter=x_data["n_iter"])
                for x_id in self.x_ids
            ]
        if "EP" in source:
            x_data = self.run_ep(**algo_kwargs)
            records += [
                dict(source="EP", x_id=x_id,
                     v=_scalar(x_data[x_id]["v"]), n_iter=x_data["n_iter"])
                for x_id in self.x_ids
            ]
            x_pred = {x_id: x_data[x_id]["r"] for x_id in self.x_ids}
            score = self.compute_score(x_pred, metrics=metrics)
            records += [
                dict(source=metric, x_id=x_id, v=score[x_id][metric])
                for metric in metrics for x_id in self.x_ids
            ]
        return records

    def run_se(self, **algo_kwargs):
        se = StateEvolution(self.student)
        se.iterate(**algo_kwargs)
        x_data = se.get_variables_data(self.x_ids)
        x_data["n_iter"] = se.n_iter
        return x_data

    def run_ep(self, **algo_kwargs):
        ep = ExpectationPropagation(self.student)
        ep.iterate(**algo_kwargs)
        x_data = ep.get_variables_data(self.x_ids)
        x_data["n_iter"] = ep.n_iter
        self.x_pred = {x_id: x_data[x_id]["r"] for x_id in self.x_ids}
        return x_data

    def ep_convergence(self, metrics, **algo_kwargs):
        import pandas as pd
        track = TrackErrors(true_values=self.x_true, metrics=metrics)
        evo = TrackEvolution(ids=self.x_ids)
        callbacks = [track, evo]
        if "callback" in algo_kwargs:
            callbacks.append(algo_kwargs["callback"])
        algo_kwargs["callback"] = JoinCallback(callbacks)
        try:
            self.run_ep(**algo_kwargs)
        except Exception as e:
            logger.error(e)
        df = pd.merge(
            track.get_dataframe(), evo.get_dataframe(), on=["id", "iter"])
        for y in ["v"] + metrics:
            df[y] = df[y].clip(0, 2)
        return df

    def se_convergence(self, **algo_kwargs):
        evo = TrackEvolution(ids=self.x_ids)
        callbacks = [evo]
        if "callback" in algo_kwargs:
            callbacks.append(algo_kwargs["callback"])
        algo_kwargs["callback"] = JoinCallback(callbacks)
        try:
            self.run_se(**algo_kwargs)
        except Exception as e:
            logger.error(e)
        df = evo.get_dataframe()
        df["v"] = df["v"].clip(0, 2)
        return df

    def compute_score(self, x_pred, metrics=["mse"]):
        return {
            x_id: {
                metric: METRICS[metric](self.x_true[x_id], x_pred[x_id])
                for metric in metrics
            }
            for x_id in self.x_ids
        }


class BayesOptimalScenario(TeacherStudentScenario):
    "Teacher == student. Reference l:143-155."

    def __init__(self, model, x_ids=["x"], y_ids=["y"]):
        super().__init__(teacher=model, student=model,
                         x_ids=x_ids, y_ids=y_ids)


def run_state_evolution(x_ids, model, **algo_kwargs):
    "Run SE for a model; returns records. Reference l:158-178."
    se = StateEvolution(model)
    se.iterate(**algo_kwargs)
    x_data = se.get_variables_data(ids=x_ids)
    return [
        dict(x_id=x_id, v=_scalar(x_data[x_id]["v"]), n_iter=se.n_iter)
        for x_id in x_ids
    ]
