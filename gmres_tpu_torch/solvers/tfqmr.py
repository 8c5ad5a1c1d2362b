"""TFQMR (Freund 1993), transpose-free quasi-minimal residual, in eager
PyTorch.

Counterpart of ``gmres_tpu/solvers/tfqmr.py``, with the same update order,
reductions and exits. An iteration is Freund's two half-steps: the odd one
uses A·u and the direction v carried from the previous even one (no
matvec), the even one applies A∘M once, ‖w‖ and ρ = (r0, w) come from one
stacked reduction, and the next A·M·u closes the iteration (two operator
and two preconditioner applications in all). Right preconditioning: the
recurrence runs on A∘M and M(u) enters the solution direction d, so d
lives in x-space.

Convergence on the quasi-residual bound τ·√(j+1) < tol after j = 2(i+1)
half-steps (it majorises ‖r‖); ρ below ``finfo(dtype).tiny`` or a
non-finite bound ends the run in BREAKDOWN. The exit is certified on the
true residual b − A x and the history (the bound after each iteration) is
padded with the final residual, as in JAX.

One host read an iteration: the bound and |ρ| come back in one stacked
tensor. ``SolveResult.host_syncs`` counts the reads: the initial residual,
one per iteration and the certification.

The loop is a generator of steps (``tfqmr_steps``): each application of A
or M and each read is a request to its runner (``solvers/requests.py``).
``tfqmr`` drives it on its own; ``solvers/batched.py`` drives one per
lane of a batched solve.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from gmres_tpu_torch.ops.blas import (
    batched_vdot,
    tree_axpy,
    tree_norm,
    tree_sub,
    tree_vdot,
    tree_zeros_like,
)
from gmres_tpu_torch.solvers.cg import _in_dtype
from gmres_tpu_torch.solvers.requests import Apply, Read, run
from gmres_tpu_torch.types import (
    LinearOperator,
    Preconditioner,
    SolveResult,
    SolverStatus,
)


def _nonzero(t: torch.Tensor) -> torch.Tensor:
    """t where |t| > 0, else 1 (a guarded divisor)."""
    return torch.where(t.abs() > 0, t, torch.ones_like(t))


def tfqmr(
    A: LinearOperator,
    b: torch.Tensor,
    *,
    tol: float = 1e-9,
    max_iterations: int = 10_000,
    M: Optional[Preconditioner] = None,
    x0: Optional[torch.Tensor] = None,
) -> SolveResult:
    """Solve A x = b (A nonsymmetric) by right-preconditioned TFQMR.

    The arguments are those of ``gmres_tpu.tfqmr``; b's device is the
    solve's. ``iterations`` counts full iterations (two half-steps, two
    matvecs); ``residual`` is the certified true ‖b − A x‖₂."""
    return run(tfqmr_steps(A, b, tol=tol, max_iterations=max_iterations, M=M,
                           x0=x0))


def tfqmr_steps(A, b, *, tol=1e-9, max_iterations=10_000, M=None, x0=None):
    """``tfqmr``'s solve as steps (``solvers/requests.py``), returning its
    SolveResult."""
    rdtype = b.real.dtype
    tiny = torch.finfo(rdtype).tiny
    tol = _in_dtype(tol, rdtype)
    if x0 is None:
        x = tree_zeros_like(b)
        r = b
    else:
        x = x0
        r = tree_sub(b, (yield Apply(A, x0)))
    r0 = r  # the shadow vector r̃₀ = r₀

    def m_apply(v):
        return (yield Apply(M, v)) if M is not None else v

    mu1 = yield from m_apply(r)
    au1 = v = yield Apply(A, mu1)  # at startup u₀ = r₀, so A·u and v coincide
    tau = tau0 = tree_norm(r)
    rho = tree_vdot(r0, r)
    w, u1, d_m = r, r, tree_zeros_like(b)
    theta = torch.zeros((), dtype=rdtype, device=b.device)
    eta = torch.zeros((), dtype=rho.dtype, device=b.device)
    tau0_f = yield Read(tau0)
    syncs = 1
    status = int(SolverStatus.CONVERGED if tau0_f < tol
                 else SolverStatus.MAX_ITERATIONS)

    def half_update(wnorm, tau, theta, eta, alpha, d_m, mu, x):
        """One half-step's quasi-minimisation: rotate (τ, θ, η) by ‖w‖,
        extend d along the x-space direction mu, update x."""
        theta_n = wnorm / torch.clamp(tau, min=tiny)
        c = 1.0 / torch.sqrt(1.0 + theta_n * theta_n)
        tau_n = tau * theta_n * c
        eta_n = c * c * alpha
        gamma = (theta * theta * eta) / _nonzero(alpha)
        d_n = tree_axpy(gamma, d_m, mu)
        return tree_axpy(eta_n, d_n, x), d_n, tau_n, theta_n, eta_n

    history = []
    i = 0
    while i < max_iterations and status == SolverStatus.MAX_ITERATIONS:
        # Odd half-step: no matvec (A·u and v come from the last even one).
        sigma = tree_vdot(r0, v)
        alpha = rho / _nonzero(sigma)
        u2 = tree_axpy(-alpha, v, u1)
        w = tree_axpy(-alpha, au1, w)
        x, d_m, tau, theta, eta = half_update(
            tree_norm(w), tau, theta, eta, alpha, d_m, mu1, x)
        # Even half-step: one matvec on M(u); ‖w‖² and ρ in one reduction.
        mu2 = yield from m_apply(u2)
        au2 = yield Apply(A, mu2)
        w = tree_axpy(-alpha, au2, w)
        wsq, rho_n = batched_vdot([(w, w), (r0, w)])
        x, d_m, tau, theta, eta = half_update(
            torch.sqrt(wsq.real), tau, theta, eta, alpha, d_m, mu2, x)
        beta = rho_n / _nonzero(rho)
        u1 = tree_axpy(beta, u2, w)
        mu1 = yield from m_apply(u1)
        au1 = yield Apply(A, mu1)  # the second matvec, and the next odd half's A·u
        v = tree_axpy(beta, tree_axpy(beta, v, au2), au1)
        rho = rho_n
        # The quasi-residual bound after j = 2(i+1) half-steps: τ_j·√(j+1).
        j = 2.0 * (float(i) + 1.0)
        bound = tau * math.sqrt(_in_dtype(j + 1.0, rdtype))
        bound_f, rho_abs = yield Read(torch.stack([bound, rho_n.abs()]))
        syncs += 1
        history.append(bound_f)
        if bound_f < tol:
            status = int(SolverStatus.CONVERGED)
        if status == SolverStatus.MAX_ITERATIONS and (
                not math.isfinite(bound_f) or rho_abs < tiny):
            status = int(SolverStatus.BREAKDOWN)
        i += 1

    # Certify the true residual (one extra matvec).
    r_true = tree_sub(b, (yield Apply(A, x)))
    true_res = tree_norm(r_true)
    true_f = yield Read(true_res)
    syncs += 1
    if status == SolverStatus.CONVERGED and true_f >= tol:
        status = int(SolverStatus.BREAKDOWN)
    res, res_f = (true_res, true_f) if i > 0 else (tau0, tau0_f)
    hist = torch.tensor(history + [res_f] * (max_iterations - i),
                        dtype=rdtype, device=b.device)
    return SolveResult(x=x, iterations=i, residual=res, status=status,
                       residual_history=hist, host_syncs=syncs)
