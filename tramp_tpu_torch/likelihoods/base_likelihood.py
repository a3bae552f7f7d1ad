"""Likelihood base class. Counterpart of
tramp_tpu/likelihoods/base_likelihood.py."""
import math

import torch

from ..base import Factor, compute_a_new, compute_ab_new


class Likelihood(Factor):
    n_next = 0
    n_prev = 1
    isotropic = True

    def get_size(self, y):
        "The size of an observation: its length, or its shape if not 1-D."
        if y is None:
            return None
        shape = tuple(y.shape) if hasattr(y, "shape") else ()
        return shape[0] if len(shape) == 1 else shape

    def prior_log_partition_FG(self, tz_hat):
        return 0.5 * torch.log(2 * math.pi / tz_hat)

    def backward_second_moment_FG(self, tz_hat):
        return 1.0 / tz_hat

    def compute_backward_message(self, az, bz):
        rz, vz = self.compute_backward_posterior(az, bz, self.y)
        return compute_ab_new(rz, vz, az, bz)

    # -- SE: the scalar_* integrands are elementwise in (bz, y) ----------
    def compute_backward_state_evolution(self, az, tau_z):
        vz = self.compute_backward_error(az, tau_z)
        return compute_a_new(vz, az)

    def compute_backward_error(self, az, tau_z):
        return self.beliefs_measure(
            az, tau_z, lambda bz, y: self.scalar_backward_variance(az, bz, y))

    def compute_backward_overlap(self, az, tau_z):
        return tau_z - self.compute_backward_error(az, tau_z)

    def compute_free_energy(self, az, tau_z):
        return self.beliefs_measure(
            az, tau_z, lambda bz, y: self.scalar_log_partition(az, bz, y))

    def compute_mutual_information(self, az, tau_z):
        "Note: returns H = mutual information I + noise entropy N."
        A = self.compute_free_energy(az, tau_z)
        return (0.5 * az * tau_z - A
                + 0.5 * torch.log(2 * math.pi * tau_z / math.e))

    # -- BO / RS state evolution (reference l:30-71) --------------------
    def compute_backward_state_evolution_BO(self, az, tz0_hat):
        vz = self.compute_backward_v_BO(az, tz0_hat)
        return compute_a_new(vz, az)

    def compute_backward_v_BO(self, az, tz0_hat):
        mz_hat = az - tz0_hat
        return self.b_measure(
            mz_hat, mz_hat, tz0_hat,
            lambda bz, y: self.scalar_backward_variance(az, bz, y))

    def compute_potential_BO(self, az, tz0_hat):
        mz_hat = az - tz0_hat
        return self.b_measure(
            mz_hat, mz_hat, tz0_hat,
            lambda bz, y: self.scalar_log_partition(az, bz, y))

    def compute_backward_vmq_RS(self, az, mz_hat, qz_hat, teacher, tz0_hat):
        vz = teacher.b_measure(
            mz_hat, qz_hat, tz0_hat,
            lambda bz, y: self.scalar_backward_variance(az, bz, y))
        mz = teacher.bz_measure(
            mz_hat, qz_hat, tz0_hat,
            lambda bz, y: self.scalar_backward_mean(az, bz, y))
        qz = teacher.b_measure(
            mz_hat, qz_hat, tz0_hat,
            lambda bz, y: self.scalar_backward_mean(az, bz, y) ** 2)
        return vz, mz, qz

    def compute_potential_RS(self, az, mz_hat, qz_hat, teacher, tz0_hat):
        return teacher.b_measure(
            mz_hat, qz_hat, tz0_hat,
            lambda bz, y: self.scalar_log_partition(az, bz, y))

    # -- dual potentials (bisection, reference l:100-118) ---------------
    def compute_precision(self, vz, tau_z, n_steps=80):
        lo = 1.0 / tau_z * torch.ones_like(vz)
        hi = 1.0 / vz
        for _ in range(n_steps):
            mid = 0.5 * (lo + hi)
            err = self.compute_backward_error(mid, tau_z) - vz
            lo = torch.where(err > 0, mid, lo)
            hi = torch.where(err > 0, hi, mid)
        return 0.5 * (lo + hi)

    def compute_dual_mutual_information(self, vz, tau_z):
        az = self.compute_precision(vz, tau_z)
        return self.compute_mutual_information(az, tau_z) - 0.5 * az * vz

    def compute_dual_free_energy(self, mz, tau_z):
        az = self.compute_precision(tau_z - mz, tau_z)
        return 0.5 * az * mz - self.compute_free_energy(az, tau_z)
