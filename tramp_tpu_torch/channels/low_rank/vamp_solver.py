"""Embedded VAMP solver for low-rank matrix factorization x = u v^T /
sqrt(N) (and the symmetric Gram case x = z z^T / sqrt(N)), with its state
evolution. Counterpart of tramp_tpu/channels/low_rank/vamp_solver.py.

Math (reference update_* methods, AMP_matrix_factorization.py:246-321):
  S = (Y/Delta)^T, R = S^2 - 1/Delta             (N, M)
  B_U = S^T V_hat / sqrt(N) - (S^2)^T C_V V_ons / N       (Onsager)
  A_U = [ (1/Delta) sum_j V_j V_j^T - sum_j R_jm C_V_j ] / N
  posterior: U_hat_m = (au I + A_U_m)^{-1} (bu_m + B_U_m), C_U_m = inverse
Damping 0.1, tol 1e-5 on overlap diffs, 25..500 iterations (l:44-55).

The JAX package's ``lax.while_loop`` is a Python loop here that reads one
flag on the host per iteration and keeps its condition exactly: ``step <=
max_iter`` and (``step <= min_iter`` or ``diff >= tol``). The per-row K x K
updates are batched einsums and one batched inverse
(``torch.linalg.inv_ex``, which does not check for singular matrices: the
JAX package's ``inv`` returns non-finite values there); the
three-operand contractions go in two steps whose intermediate is ``(N, K,
K)``, never ``(N, M, K, K)``. TF32 must stay off for these products (the
JAX bench runs them at "highest" precision: reduced precision took 4.4x
the iterations).

Lanes: ``bx`` ``(B, M, N)`` is B instances, with ``ax`` a number or ``(B,
1, 1)``, ``bu`` ``(B, M, K)``, ``bv`` ``(B, N, K)`` and ``au``, ``av``
numbers or ``(B, 1, 1)``. Every lane runs until its own condition fails and
is then frozen while the others go on (the semantics of a ``vmap`` of the
``while_loop``), so lane i is its single solve. The loop computes nothing
on meta tensors (the engine's shape sweep)."""
import math

import torch

from ...config import default_device
from ...lanes import select


def _lanes(x):
    "A number, or a per-lane tensor (B, 1, 1), as it broadcasts per lane."
    if isinstance(x, torch.Tensor) and x.ndim > 0:
        return x.reshape(-1, 1, 1)
    return x


def _posterior(A, B, a0, b0):
    """Batched Gaussian posterior: for each lane and row m solve
    (a0 I + A[m]) r = (b0[m] + B[m]); C[m] = (a0 I + A[m])^{-1}.
    A: (b, M, K, K), B and b0: (b, M, K), a0 a number or (b, 1, 1)."""
    K = B.shape[-1]
    eye = torch.eye(K, dtype=A.dtype, device=A.device)
    a0 = a0.unsqueeze(-1) if isinstance(a0, torch.Tensor) and a0.ndim else a0
    # the JAX package's inverse returns inf or nan for a singular matrix
    # where torch.linalg.inv raises (and syncs the host to check)
    C = torch.linalg.inv_ex(a0 * eye + A)[0]
    r = torch.einsum("bmkl,bml->bmk", C, b0 + B)
    return r, C


def vamp_matrix_factorization(au, av, bu, bv, ax, bx, model="UV",
                              max_iter=500, min_iter=25, tol=1e-5,
                              damping=0.1, return_marginals=False,
                              stats=None):
    """Run the VAMP matrix-factorization solver.

    Natural-parameter messages on u (M, K), v (N, K) and the observation
    channel x (M, N) with precision ax and bx (M, N); lanes as in the
    module docstring. Returns (rz_u (M, K), vz_u, rz_v (N, K), vz_v), the
    variances 0-d or ``(B, 1, 1)``; with ``return_marginals=True`` the
    per-row posterior marginals (U_hat (M, K), C_U (M, K, K), V_hat (N, K),
    C_V (N, K, K)), each with the lane axis first, are appended. ``stats``,
    a dict, gains the number of solves ("solves") and of loop iterations
    ("iterations")."""
    lanes = bx.ndim == 3
    bx = bx if lanes else bx.unsqueeze(0)
    b, M, N = bx.shape
    dtype, device = bx.dtype, bx.device
    bu = torch.as_tensor(bu, dtype=dtype, device=device)
    bv = torch.as_tensor(bv, dtype=dtype, device=device)
    bu = bu.expand(b, *bu.shape[-2:]) if bu.ndim == 2 else bu
    bv = bv.expand(b, *bv.shape[-2:]) if bv.ndim == 2 else bv
    K = bu.shape[-1]
    au, av = _lanes(au), _lanes(av)

    # ax floor: inside an EP sweep the first forward pass sees the
    # uninformative (ax=0, bx=0) init from the x side (the likelihood's
    # backward message is only written later in the sweep); 0/0 here
    # would poison the whole engine state. At the floor Delta caps at
    # 1/AMIN, an (almost) data-free solve that returns about the prior.
    ax = torch.clamp(torch.as_tensor(_lanes(ax), dtype=dtype, device=device),
                     min=1e-11)
    Y = bx / ax
    Delta = torch.clamp(1.0 / ax, min=1e-2)
    S = (Y / Delta).transpose(1, 2)          # (b, N, M)
    S2 = S**2
    R = S2 - 1.0 / Delta                      # (b, N, M)
    S2R = S2 - R
    sqrtN = math.sqrt(1.0 * N)

    def outer(hat):
        return torch.einsum("bjk,bjl->bjkl", hat, hat)

    def A_update(hat_other, C_other):
        # A_self[m] = (sum_j (S2-R)_jm hat_j hat_j^T - sum_j R_jm C_j) / N
        return (torch.einsum("bjm,bjkl->bmkl", S2R, outer(hat_other))
                - torch.einsum("bjm,bjkl->bmkl", R, C_other)) / N

    def A_V_update(U_hat, C_U):
        return (torch.einsum("bjm,bmkl->bjkl", S2R, outer(U_hat))
                - torch.einsum("bjm,bmkl->bjkl", R, C_U)) / N

    # initialization (reference l:130-245): hats at 0.1, covs at 0.01 I
    eye = torch.eye(K, dtype=dtype, device=device)
    V_hat = 0.1 * torch.ones((b, N, K), dtype=dtype, device=device)
    C_V = (0.01 * eye).expand(b, N, K, K)
    if model == "XX":
        U_hat, C_U = V_hat, C_V
    else:
        U_hat = 0.1 * torch.ones((b, M, K), dtype=dtype, device=device)
        C_U = (0.01 * eye).expand(b, M, K, K)

    # first A/B without Onsager terms (reference l:196-201, 240-245)
    B_V = torch.einsum("bjm,bmk->bjk", S, U_hat) / sqrtN
    A_V = A_V_update(U_hat, C_U)
    B_U = torch.einsum("bjm,bjk->bmk", S, V_hat) / sqrtN
    A_U = torch.abs(A_update(V_hat, C_V))

    U_ons, V_ons = U_hat, V_hat
    V_hat, C_V = _posterior(A_V, B_V, av, bv)
    if model == "XX":
        U_hat, C_U = V_hat, C_V
    else:
        U_hat, C_U = _posterior(A_U, B_U, au, bu)

    def gram(hat, n):
        return hat.transpose(1, 2) @ hat / n

    q_v, q_u = gram(V_hat, N), gram(U_hat, M)

    def damp(new, old):
        return (1.0 - damping) * new + damping * old

    def body(carry):
        (U_hat, C_U, V_hat, C_V, U_ons, V_ons, A_U, B_U, A_V, B_V,
         q_u, q_v, step, diff) = carry
        # A_V, B_V from the U side. The Onsager corrections use the previous
        # iteration's hats (reference AMP_step, l:438-462: V_hat_onsager /
        # U_hat_onsager are copied only after the B updates, so update_B_V
        # sees V(t-1) while the S-term sees U(t)).
        A_V_new = damp(A_V_update(U_hat, C_U), A_V)
        onsager_v = torch.einsum(
            "bjkl,bjl->bjk", torch.einsum("bjm,bmkl->bjkl", S2, C_U), V_ons)
        B_V_new = damp(torch.einsum("bjm,bmk->bjk", S, U_hat) / sqrtN
                       - onsager_v / N, B_V)
        # A_U, B_U from the V side (with a one-step-stale Onsager on U)
        A_U_new = damp(A_update(V_hat, C_V), A_U)
        onsager_u = torch.einsum(
            "bmkl,bml->bmk", torch.einsum("bjm,bjkl->bmkl", S2, C_V), U_ons)
        B_U_new = damp(torch.einsum("bjm,bjk->bmk", S, V_hat) / sqrtN
                       - onsager_u / N, B_U)

        U_ons_new, V_ons_new = U_hat, V_hat
        V_hat_new, C_V_new = _posterior(A_V_new, B_V_new, av, bv)
        if model == "XX":
            U_hat_new, C_U_new = V_hat_new, C_V_new
        else:
            U_hat_new, C_U_new = _posterior(A_U_new, B_U_new, au, bu)

        q_v_new, q_u_new = gram(V_hat_new, N), gram(U_hat_new, M)
        dv = torch.linalg.matrix_norm(q_v_new - q_v)
        du = torch.linalg.matrix_norm(q_u_new - q_u)
        d = torch.maximum(dv, du) / (K**2)
        diff_new = torch.where(step > min_iter, d, diff)
        return (U_hat_new, C_U_new, V_hat_new, C_V_new,
                U_ons_new, V_ons_new,
                A_U_new, B_U_new, A_V_new, B_V_new,
                q_u_new, q_v_new, step + 1, diff_new)

    carry = (U_hat, C_U, V_hat, C_V, U_ons, V_ons, A_U, B_U, A_V, B_V,
             q_u, q_v, torch.zeros(b, dtype=torch.int64, device=device),
             torch.full((b,), 10.0 * tol, dtype=dtype, device=device))
    iterations = 0
    while device.type != "meta":
        step, diff = carry[-2:]
        active = (step <= max_iter) & ((step <= min_iter) | (diff >= tol))
        # the one host read of the iteration
        if not bool(active.any()):
            break
        new = body(carry)
        # lanes whose condition failed are frozen, as under vmap (one lane
        # is here only while its condition holds)
        carry = new if b == 1 else tuple(
            select(active, n, o) for n, o in zip(new, carry))
        iterations += 1
    U_hat, C_U, V_hat, C_V = carry[:4]
    if stats is not None:
        stats["solves"] = stats.get("solves", 0) + 1
        stats["iterations"] = stats.get("iterations", 0) + iterations

    def variance(C):
        v = torch.diagonal(C, dim1=-2, dim2=-1).sum(-1).mean(-1) / K
        return v.reshape(b, 1, 1) if lanes else v.reshape(())

    def out(x):
        return x if lanes else x[0]

    result = (out(U_hat), variance(C_U), out(V_hat), variance(C_V))
    if return_marginals:
        return result + ((out(U_hat), out(C_U), out(V_hat), out(C_V)),)
    return result


def forward_posterior_from_marginals(U_hat, C_U, V_hat, C_V, N):
    """Moment-matched forward posterior on x = u v^T / sqrt(N) from the
    embedded VAMP's per-row marginals (posterior independence across rows,
    the solver's own factorization assumption):

        rx_ij = U_hat_i . V_hat_j / sqrt(N)
        vx    = [ mean_i u_i^T Cbar_V u_i + mean_j v_j^T Cbar_U v_j
                  + tr(Cbar_U Cbar_V) ] / N        (isotropic average)

    with Cbar_* the row-averaged covariances. Reference
    vamp_solver.py:163-185. With lanes (a first axis on every marginal)
    vx is ``(B, 1, 1)``."""
    lanes = U_hat.ndim == 3
    rx = U_hat @ V_hat.transpose(-1, -2) / math.sqrt(1.0 * N)
    Cu_bar = torch.mean(C_U, dim=-3)
    Cv_bar = torch.mean(C_V, dim=-3)
    t_u = torch.einsum("...ik,...kl,...il->...i", U_hat, Cv_bar, U_hat)
    t_v = torch.einsum("...jk,...kl,...jl->...j", V_hat, Cu_bar, V_hat)
    t_c = torch.diagonal(Cu_bar @ Cv_bar, dim1=-2, dim2=-1).sum(-1)
    vx = (t_u.mean(-1) + t_v.mean(-1) + t_c) / N
    return rx, (vx.reshape(-1, 1, 1) if lanes else vx)


def _sp_q(Sigma, lam, gamma):
    """One side of the K x K overlap saddle point (reference
    SE_matrix_factorization.py:53-85, SP_qv/SP_qu): the updated overlap
    matrix given the effective-SNR matrix ``gamma``, prior covariance
    ``Sigma`` (K x K) and prior mean ``lam`` (K,)."""
    inv_S = torch.linalg.inv(Sigma)
    t1 = torch.linalg.inv(Sigma + gamma)
    ll = torch.outer(lam, lam)
    mid = (inv_S @ ll @ inv_S + gamma + gamma @ Sigma @ gamma.T
           + gamma @ ll @ gamma + 2.0 * inv_S @ ll @ gamma)
    return t1 @ mid @ t1


def _se_tensor(x, device, dtype):
    return torch.as_tensor(x, device=device, dtype=dtype)


def _se_place(values, device, dtype):
    """(device, dtype) of an SE computation: those of the first tensor among
    ``values``, else ``device`` (None: the first card) and ``dtype`` (None:
    float64)."""
    for x in values:
        if isinstance(x, torch.Tensor):
            return x.device, x.dtype
    return device or default_device(), dtype or torch.float64


def se_matrix_factorization_kk(au, av, ax, model, K, alpha=1.0,
                               lam_u=None, lam_v=None,
                               q0_u=None, q0_v=None,
                               max_iter=10_000, min_iter=50, tol=1e-5,
                               damping=0.0, device=None, dtype=None):
    """Full K x K low-rank state evolution with prior-mean terms: the
    overlap matrices q_u, q_v (K x K) iterate

        gamma_u = alpha q_u / Delta   (UV)  |  q_v / Delta   (XX)
        q_v <- SP(Sigma_v, lam_v, gamma_u)
        gamma_v = q_v / Delta
        q_u <- SP(Sigma_u, lam_u, gamma_v)  (UV)  |  q_v   (XX)

    in the reference's Jacobi order (SE_matrix_factorization.py:53-101).
    Sigma_* = (1/a*) I; the default init is 0.8 I + 0.1. ``damping``
    stabilizes the recursion at high SNR without moving its fixed point
    (the channels' SE routing uses 0.5). The loop reads one flag on the
    host per iteration. Reference vamp_solver.py:201-275.

    Returns (mse_u, mse_v): the K x K error matrices Sigma - q at the fixed
    point. ``device``, ``dtype``: those of a tensor argument, else the
    first card (None) and float64."""
    device, dtype = _se_place((au, av, ax, q0_u, q0_v, lam_u, lam_v),
                              device, dtype)
    eye = torch.eye(K, device=device, dtype=dtype)
    Sigma_u = (1.0 / _se_tensor(au, device, dtype)) * eye
    Sigma_v = (1.0 / _se_tensor(av, device, dtype)) * eye
    zeros = torch.zeros(K, device=device, dtype=dtype)
    lam_u = zeros if lam_u is None else _se_tensor(lam_u, device, dtype)
    lam_v = zeros if lam_v is None else _se_tensor(lam_v, device, dtype)
    Delta = 1.0 / _se_tensor(ax, device, dtype)
    init = 0.8 * eye + 0.1 * torch.ones((K, K), device=device, dtype=dtype)
    q_u = init if q0_u is None else _se_tensor(q0_u, device, dtype)
    q_v = init if q0_v is None else _se_tensor(q0_v, device, dtype)

    def rel(n, o):
        return torch.linalg.matrix_norm(n - o) / torch.clamp(
            torch.linalg.matrix_norm(n), min=1e-30)

    step, diff = 0, 10.0 * tol
    while step < max_iter and (step < min_iter or diff >= tol):
        # Jacobi order, like the reference's iteration(): SP_qu reads the
        # pre-update q_v (SE_matrix_factorization.py:86-95)
        gamma_u = alpha * q_u / Delta if model == "UV" else q_v / Delta
        q_v_new = _sp_q(Sigma_v, lam_v, gamma_u)
        if model == "UV":
            q_u_new = _sp_q(Sigma_u, lam_u, q_v / Delta)
        else:
            q_u_new = q_v_new
        if damping:
            q_u_new = (1.0 - damping) * q_u_new + damping * q_u
            q_v_new = (1.0 - damping) * q_v_new + damping * q_v
        d = torch.maximum(rel(q_u_new, q_u), rel(q_v_new, q_v))
        q_u, q_v, step = q_u_new, q_v_new, step + 1
        # the one host read of the iteration
        diff = float(d)
    return Sigma_u - q_u, Sigma_v - q_v


def se_matrix_factorization(au, av, ax, model, K, N, M, max_iter=200,
                            tol=1e-6, device=None, dtype=None):
    """State evolution of the low-rank factorization, the Bayes-optimal
    fixed point of the isotropic scalar overlap recursion (reference
    vamp_solver.py:278-305), ``max_iter`` iterations. The precisions are
    numbers, 0-d tensors or one value per lane; ``device`` and ``dtype``
    as in ``se_matrix_factorization_kk``."""
    device, dtype = _se_place((au, av, ax), device, dtype)
    au, av, ax = (_se_tensor(x, device, dtype) for x in (au, av, ax))
    tau_u = 1.0 / au
    tau_v = 1.0 / av
    Delta = torch.clamp(1.0 / ax, min=1e-2)
    alpha = M / N
    q_u, q_v = 0.01 * tau_u, 0.01 * tau_v
    for _ in range(max_iter):
        # effective SNRs
        m_v_hat = alpha * q_u / Delta
        q_v = tau_v * m_v_hat * tau_v / (1.0 + m_v_hat * tau_v)
        m_u_hat = q_v / Delta
        q_u = tau_u * m_u_hat * tau_u / (1.0 + m_u_hat * tau_u)
    vz_u = tau_u - q_u
    vz_v = tau_v - q_v
    if model == "XX":
        return vz_v
    return vz_u, vz_v
