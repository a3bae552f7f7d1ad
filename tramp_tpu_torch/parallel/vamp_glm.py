"""Spectral VAMP fast path for GLM chains: prior @ LinearChannel @
GaussianLikelihood. Counterpart of tramp_tpu/parallel/vamp_glm.py.

VAMP (Rangan, Schniter, Fletcher, "Vector Approximate Message Passing",
2019: the same moment-matching fixed point as EP on this factor chain)
keeps the Gaussian-likelihood LMMSE step in the SVD basis: per iteration
only two dense products against the thin factor V_k (Nz, k),
k = min(Nx, Nz), remain, V_k^T r2 into the spectral basis and V_k (d - t)
back out; the complement modes ride along analytically
(x2 = r2 + V_k (d - t), since d_perp = t_perp).

Iteration (standard VAMP form; gamma = cavity precisions):
  x1, v1 = prior_denoise(r1, gamma1)          # separable prior posterior
  alpha1 = gamma1 <v1>;  r2 = (x1 - alpha1 r1)/(1 - alpha1)
  gamma2 = gamma1 (1 - alpha1)/alpha1
  d  = (gamma2 V^T r2 + S U^T y / Delta) / (S^2/Delta + gamma2)   # LMMSE
  x2 = V d;  alpha2 = gamma2 <(S^2/Delta + gamma2)^{-1}>
  r1 = (x2 - alpha2 r2)/(1 - alpha2);  gamma1 = gamma2 (1 - alpha2)/alpha2

Convergence is measured on the mean posterior variance <v1>, like the
reference's EarlyStopping.

The JAX package compiles the loop (``lax.while_loop``) and batches it with
``jax.vmap``. Here the loop is ``parallel/loop.py``'s, and the batch is a
lane axis written out (tramp_tpu_torch/lanes.py): ``r1`` is ``(B, Nz)``,
``gamma1`` ``(B, 1)``, and with one shared operator the two products are
GEMMs. Its iteration here (``SpectralVAMPSolver._iterate``): a step that is
not finite is dropped and ends its lane, and a lane that is done is frozen
(its carry, its ``v1`` and its ``n_iter`` stay). The loop runs eagerly
everywhere: it keeps no plan.
"""
import torch

from .. import config
from ..channels import LinearChannel
from ..lanes import (
    advance, last_axis, lane_count, lane_mean, lane_values, model_lanes,
    per_lane, select_,
)
from ..likelihoods import GaussianLikelihood
from .loop import SolverLoop, start_flags
from .mesh import whole_batch


def _find_glm_parts(model):
    "Extract the exact (prior, LinearChannel, GaussianLikelihood) chain."
    factors = list(model.factors)
    ok = (len(factors) == 3
          and factors[0].n_prev == 0
          and isinstance(factors[1], LinearChannel)
          and isinstance(factors[2], GaussianLikelihood)
          and factors[2].y is not None)
    if not ok:
        raise ValueError(
            "SpectralVAMPSolver needs exactly a prior @ LinearChannel @ "
            f"GaussianLikelihood chain, got {factors}")
    return factors[0], factors[1], factors[2]


class SpectralVAMPSolver(SolverLoop):
    """VAMP on a GLM chain, diagonalized in the SVD basis.

    ``model`` fixes the static structure (one instance); solve calls accept
    any model of the same structure, on the device of its own buffers.
    ``solve_batch`` takes a model whose buffers carry lanes: a buffer has
    lanes when it has one axis more than the same buffer of ``model``
    (``lanes.model_lanes``), so both whole stacked models
    (``lanes.stack_models``) and one shared operator with an observation per
    lane (``lanes.with_buffers``) work. ``damping`` damps the r1/gamma1
    update (rarely needed for i.i.d. ensembles)."""

    #: no plan: the loop runs eagerly on the card too
    _plans = None

    def __init__(self, model, damping=None, tol=1e-6, max_iter=200):
        _find_glm_parts(model)  # validate structure
        self.template = model
        self.x_id, self.z_id = model.variable_ids
        self.tol = tol
        self.max_iter = max_iter
        self.damping = 0.0 if damping is None else float(damping)

    def _spectral(self, model):
        "Loop-invariant spectral quantities (thin k-length vectors)."
        prior, lin, lik = _find_glm_parts(model)
        Delta = lik.var
        uy = lin._mm(lin.U, lik.y, transpose=True,   # (k,)
                     lanes=model_lanes(model, self.template) is not None)
        p = lin.s * uy / Delta                       # (k,)
        s2d = lin.s**2 / Delta                       # (k,)
        return prior, lin, p, s2d

    @staticmethod
    def _lmmse_input(prior, r1, gamma1):
        """The prior's denoising step and the cavity it hands to the LMMSE
        step: (x1, v1, r2, gamma2)."""
        x1, v1 = prior.compute_forward_posterior(gamma1, gamma1 * r1)
        v1 = lane_mean(v1, gamma1)
        alpha1 = torch.clamp(gamma1 * v1, 1e-11, 1.0 - 1e-11)
        r2 = (x1 - alpha1 * r1) / (1.0 - alpha1)
        gamma2 = torch.clamp(gamma1 * (1.0 - alpha1) / alpha1,
                             config.AMIN, config.AMAX)
        return x1, v1, r2, gamma2

    def _step(self, model, carry, spectral=None):
        """One VAMP iteration from ``carry = (r1, gamma1)``; returns the new
        carry and the prior's posterior (x1, v1). ``spectral``: the result
        of ``_spectral(model)``, which the loop computes once."""
        prior, lin, p, s2d = spectral or self._spectral(model)
        r1, gamma1 = carry
        x1, v1, r2, gamma2 = self._lmmse_input(prior, r1, gamma1)
        lanes = lane_count(gamma2, r2) is not None
        t = lin._mm(lin.V, r2, transpose=True, lanes=lanes)    # (k,)
        den = s2d + gamma2
        d = (gamma2 * t + p) / den
        if lin.k == lin.Nz:
            x2 = lin._mm(lin.V, d, lanes=lanes)
            inv_den_mean = last_axis(1.0 / den, torch.mean)
        else:
            # complement modes (s=0): d_perp = t_perp, so
            # x2 = V_k d + V_perp V_perp^T r2 = r2 + V_k (d - t)
            x2 = r2 + lin._mm(lin.V, d - t, lanes=lanes)
            inv_den_mean = (last_axis(1.0 / den, torch.sum)
                            + (lin.Nz - lin.k) / gamma2) / lin.Nz
        alpha2 = torch.clamp(gamma2 * inv_den_mean, 1e-11, 1.0 - 1e-11)
        r1_new = (x2 - alpha2 * r2) / (1.0 - alpha2)
        gamma1_new = torch.clamp(gamma2 * (1.0 - alpha2) / alpha2,
                                 config.AMIN, config.AMAX)
        damp = self.damping
        if damp:
            r1_new = damp * r1 + (1.0 - damp) * r1_new
            gamma1_new = damp * gamma1 + (1.0 - damp) * gamma1_new
        return (r1_new, gamma1_new), (x1, v1)

    def _init(self, model, spectral=None):
        """(r1, gamma1) of the uninformative start: the prior-only cavity
        (reference a=0 init clipped to AMIN); with the lanes of ``model``."""
        _, lin, p, _ = spectral or self._spectral(model)
        lanes = tuple(p.shape[:-1])
        r1 = torch.zeros(lanes + (lin.Nz,), dtype=p.dtype, device=p.device)
        gamma1 = torch.full(lanes + (1,) * len(lanes), config.AMIN,
                            dtype=p.dtype, device=p.device)
        return r1, gamma1

    def _prepare(self, model, carry):
        "The run's lane count, device and spectral quantities; no carry."
        spectral = self._spectral(model)
        return (model_lanes(model, self.template), spectral[2].device,
                spectral, None)

    def _start(self, model, spectral, B, carry):
        """The loop's state before its first iteration, which ``_iterate``
        updates in place: the uninformative carry, the last mean variance
        ``v1`` (none yet: infinite) and the flags."""
        carry = self._init(model, spectral)
        p = spectral[2]
        flags = start_flags(B, p.device)
        return {"carry": carry, "flags": flags,
                "metric": torch.full(flags["done"].shape, float("inf"),
                                     dtype=p.dtype, device=p.device)}

    def _iterate(self, model, spectral, B, loop, tol):
        """One iteration of the loop, in place on ``loop`` (``_start``): the
        step, the finite test, the frozen lanes, the stop metric and the
        flags."""
        carry, old_v, flags = loop["carry"], loop["metric"], loop["flags"]
        new, (_, v1) = self._step(model, carry, spectral)
        v1 = v1.reshape(old_v.shape)
        ok = (torch.isfinite(per_lane(new[0], B)).all(-1)
              & torch.isfinite(new[1]).reshape(old_v.shape))
        # a step that is not finite is dropped and ends its lane; a lane
        # that is done is frozen (without lanes the loop ends with it)
        active = ~flags["done"]
        keep = ok if B is None else ok & active
        for n, o in zip(new, carry):
            select_(keep, n, o)
        converged = (torch.abs(v1 - old_v) < tol) & (flags["count"] > 0)
        # a done lane's v1 is read by nothing: no select
        old_v.copy_(v1)
        advance(flags, active, converged, ~ok)

    def _readout(self, model, carry, spectral, B):
        """The posteriors from the converged cavity (keys: the model's
        variable ids, as EPSolver returns them)."""
        prior, lin, p, s2d = spectral
        r1, gamma1 = carry
        x1, v1, r2, gamma2 = self._lmmse_input(prior, r1, gamma1)
        # z = W x posterior: one readout LMMSE pass (not per iteration)
        lanes = B is not None
        t = lin._mm(lin.V, r2, transpose=True, lanes=lanes)    # (k,)
        den = s2d + gamma2
        d = (gamma2 * t + p) / den
        # z = W x: only the k signal modes contribute (s=0 beyond k)
        z_hat = lin._mm(lin.U, lin.s * d, lanes=lanes)
        v_z = last_axis(lin.s**2 / den, torch.sum) / lin.Nx
        return {self.x_id: {"r": x1, "v": lane_values(v1, B)},
                self.z_id: {"r": z_hat, "v": lane_values(v_z, B)}}

    def solve(self, model):
        "One instance: ({id: {r, v}}, n_iter)."
        post, _, n_iter, _ = self._run(model)
        return post, n_iter

    def solve_info(self, model):
        "Like solve, with the converged flag (True iff delta < tol fired)."
        post, _, n_iter, conv = self._run(model)
        return post, n_iter, conv

    def solve_batch(self, stacked_model):
        """Many instances in one loop: ``r`` comes back ``(B, n)``, ``v`` and
        ``n_iter`` ``(B,)``. The loop runs until every lane is done. On a
        sharded model (``parallel.shard_batched_model``) every rank returns
        the whole batch."""
        post, _, n_iter, _ = self._solve_batch(stacked_model)
        return whole_batch((post, n_iter), stacked_model)

    def _solve_batch(self, stacked_model, initializer=None, state=None,
                     stop=None):
        """The batched loop on this rank's lanes: (post, None, n_iter,
        conv), not gathered. The loop starts from the prior-only cavity:
        it takes no initializer and no state."""
        if initializer is not None or state is not None:
            raise ValueError("SpectralVAMPSolver starts from the prior-only "
                             "cavity: no initializer or state")
        if model_lanes(stacked_model, self.template) is None:
            raise ValueError("solve_batch: no buffer of the model has lanes")
        post, _, n_iter, conv = self._run(stacked_model, stop=stop)
        return post, None, n_iter, conv
