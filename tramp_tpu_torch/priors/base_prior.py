"""Prior base class. Counterpart of tramp_tpu/priors/base_prior.py: the
quadrature measures are fixed-node rules (utils/integration.py) and the dual
potentials are solved by bisection."""
import torch

from ..base import Factor, compute_a_new, compute_ab_new


class Prior(Factor):
    n_next = 1
    n_prev = 0
    isotropic = True

    # -- EP ------------------------------------------------------------
    def compute_forward_message(self, ax, bx):
        rx, vx = self.compute_forward_posterior(ax, bx)
        return compute_ab_new(rx, vx, ax, bx)

    # -- SE (Bayes-optimal / replica-symmetric) -------------------------
    # The scalar_* integrands are elementwise in bx: the quadrature calls
    # them on all its nodes at once, so they take no isotropic mean.
    def prior_log_partition_FG(self, tx_hat):
        return self.scalar_log_partition(ax=tx_hat,
                                         bx=torch.zeros_like(tx_hat))

    def compute_forward_state_evolution(self, ax):
        vx = self.compute_forward_error(ax)
        return compute_a_new(vx, ax)

    def compute_forward_error(self, ax):
        return self.beliefs_measure(
            ax, lambda bx: self.scalar_forward_variance(ax, bx))

    def compute_forward_overlap(self, ax):
        return self.second_moment() - self.compute_forward_error(ax)

    def compute_free_energy(self, ax):
        return self.beliefs_measure(
            ax, lambda bx: self.scalar_log_partition(ax, bx))

    def compute_mutual_information(self, ax):
        tau_x = self.second_moment()
        return 0.5 * ax * tau_x - self.compute_free_energy(ax)

    def compute_forward_state_evolution_BO(self, ax, tx0_hat):
        vx = self.compute_forward_v_BO(ax, tx0_hat)
        return compute_a_new(vx, ax)

    def compute_forward_v_BO(self, ax, tx0_hat):
        mx_hat = ax - tx0_hat
        return self.b_measure(
            mx_hat, mx_hat, tx0_hat,
            lambda bx: self.scalar_forward_variance(ax, bx))

    def compute_potential_BO(self, ax, tx0_hat):
        mx_hat = ax - tx0_hat
        return self.b_measure(
            mx_hat, mx_hat, tx0_hat,
            lambda bx: self.scalar_log_partition(ax, bx))

    def compute_forward_vmq_RS(self, ax, mx_hat, qx_hat, teacher, tx0_hat):
        vx = teacher.b_measure(
            mx_hat, qx_hat, tx0_hat,
            lambda bx: self.scalar_forward_variance(ax, bx))
        mx = teacher.bx_measure(
            mx_hat, qx_hat, tx0_hat,
            lambda bx: self.scalar_forward_mean(ax, bx))
        qx = teacher.b_measure(
            mx_hat, qx_hat, tx0_hat,
            lambda bx: self.scalar_forward_mean(ax, bx) ** 2)
        return vx, mx, qx

    def compute_potential_RS(self, ax, mx_hat, qx_hat, teacher, tx0_hat):
        return teacher.b_measure(
            mx_hat, qx_hat, tx0_hat,
            lambda bx: self.scalar_log_partition(ax, bx))

    # -- dual potentials (bisection, reference base_prior.py:88-107) ----
    def compute_precision(self, vx, n_steps=80):
        "Solve compute_forward_error(ax) = vx for ax by bisection in [0, 1/vx]."
        lo = torch.zeros_like(vx)
        hi = 1.0 / vx
        for _ in range(n_steps):
            mid = 0.5 * (lo + hi)
            err = self.compute_forward_error(mid) - vx
            # error is decreasing in ax
            lo = torch.where(err > 0, mid, lo)
            hi = torch.where(err > 0, hi, mid)
        return 0.5 * (lo + hi)

    def compute_dual_mutual_information(self, vx):
        ax = self.compute_precision(vx)
        return self.compute_mutual_information(ax) - 0.5 * ax * vx

    def compute_dual_free_energy(self, mx):
        tau_x = self.second_moment()
        ax = self.compute_precision(tau_x - mx)
        return 0.5 * ax * mx - self.compute_free_energy(ax)
