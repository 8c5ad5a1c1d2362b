"""BiCGstab(ℓ) (Sleijpen & Fokkema 1993) in eager PyTorch.

Counterpart of ``gmres_tpu/solvers/bicgstabl.py``, with the same update
order, reductions and exits. A cycle performs ℓ BiCG steps (2ℓ
applications of A∘M) and closes them with one degree-ℓ minimal-residual
polynomial, from a modified Gram-Schmidt of r₁…r_ℓ whose dots for each j
come from one stacked reduction. Right preconditioning: the recurrence
runs on A∘M and the solution is mapped through M once at exit, so M's
precision bounds the attainable accuracy.

* Convergence on the absolute ‖r‖₂ < tol at cycle boundaries. A pivot
  (ρ, γ or σ_j) at or below ``finfo(dtype).tiny`` before convergence, or a
  non-finite residual, ends the run in BREAKDOWN.
* van der Vorst–Ye residual replacement (``reliable``): a drift bound
  d += ε·(‖A∘M‖‖y‖ + ‖r‖) accumulates each cycle (‖A∘M‖ from one probe
  before the loop); when it first crosses δ·‖r‖ the recursive r is
  replaced by r_init − (A∘M)(y) (one application) and the bound resets.
* The exit is certified on the true residual b − A x; the history is
  padded with the final residual, as in JAX.

One host read a cycle: ‖r‖, the pivots' verdict and the device half of the
replacement trigger (below the δ·‖r‖ threshold before, at or above it now)
come back in one stacked tensor; ``lax.cond(trigger, replace, …)`` becomes
a Python branch on that read. ``SolveResult.host_syncs`` counts the reads:
the initial residual, one per cycle and the certification.

The loop is a generator of steps (``bicgstabl_steps``): each application
of A or M and each read is a request to its runner
(``solvers/requests.py``). ``bicgstabl`` drives it on its own;
``solvers/batched.py`` drives one per lane of a batched solve.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from gmres_tpu_torch.ops.blas import (
    batched_vdot,
    tree_axpy,
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


def bicgstabl(
    A: LinearOperator,
    b: torch.Tensor,
    *,
    ell: int = 2,
    tol: float = 1e-9,
    max_iterations: int = 10_000,
    M: Optional[Preconditioner] = None,
    x0: Optional[torch.Tensor] = None,
    reliable: bool = True,
    replace_delta: Optional[float] = None,
) -> SolveResult:
    """Solve A x = b by BiCGstab(ℓ) with optional right preconditioning.

    The arguments are those of ``gmres_tpu.bicgstabl``; b's device is the
    solve's. ``max_iterations`` and ``iterations`` count outer cycles (2ℓ
    applications of A and M each). replace_delta: the replacement threshold
    δ (default √ε of the dtype)."""
    if ell < 1:
        raise ValueError(f"ell must be >= 1, got {ell}")
    return run(bicgstabl_steps(A, b, ell=ell, tol=tol, max_iterations=max_iterations,
                               M=M, x0=x0, reliable=reliable,
                               replace_delta=replace_delta))


def bicgstabl_steps(A, b, *, ell=2, tol=1e-9, max_iterations=10_000, M=None, x0=None,
                    reliable=True, replace_delta=None):
    """``bicgstabl``'s solve as steps (``solvers/requests.py``), returning
    its SolveResult."""
    if ell < 1:
        raise ValueError(f"ell must be >= 1, got {ell}")

    def op(v):
        """A∘M: M's request, then A's."""
        return (yield Apply(A, (yield Apply(M, v)) if M is not None else v))

    y = tree_zeros_like(b)
    # x0 is folded into the right-hand side's residual; y runs from 0.
    r = b if x0 is None else tree_sub(b, (yield Apply(A, x0)))
    r_tilde = r_init = r

    dtype = b.dtype
    finfo = torch.finfo(dtype)
    eps, mach_eps = finfo.tiny, finfo.eps
    delta = (float(replace_delta) if replace_delta is not None
             else mach_eps ** 0.5)
    delta_t = _in_dtype(delta, dtype)
    tol = _in_dtype(tol, dtype)
    if reliable:
        ar0 = yield from op(r)
        norm_A = torch.sqrt(tree_vdot(ar0, ar0)
                            / torch.clamp(tree_vdot(r, r), min=eps))

    def nonzero(t):
        return torch.where(t.abs() > eps, t, 1.0)

    res0 = torch.sqrt(tree_vdot(r, r))
    res0_f = yield Read(res0)
    status = int(SolverStatus.CONVERGED if res0_f < tol
                 else SolverStatus.MAX_ITERATIONS)
    syncs = 1
    one = torch.ones((), dtype=dtype, device=b.device)
    u0v, rho0, alpha, omega = tree_zeros_like(b), one, torch.zeros_like(one), one
    drift = torch.zeros_like(one)
    below = torch.ones((), dtype=torch.bool, device=b.device)
    history = []
    k = 0
    while k < max_iterations and status == SolverStatus.MAX_ITERATIONS:
        rho0 = -omega * rho0
        # BiCG part: u_0..u_ℓ and r_0..r_ℓ.
        us = [u0v] + [None] * ell
        rs = [r] + [None] * ell
        ok = torch.ones((), dtype=torch.bool, device=b.device)
        for j in range(ell):
            rho1 = tree_vdot(rs[j], r_tilde)
            ok = ok & (rho0.abs() > eps)
            beta = alpha * rho1 / nonzero(rho0)
            rho0 = rho1
            for i in range(j + 1):
                us[i] = tree_axpy(-beta, us[i], rs[i])
            us[j + 1] = yield from op(us[j])
            gamma = tree_vdot(us[j + 1], r_tilde)
            ok = ok & (gamma.abs() > eps)
            alpha = rho0 / nonzero(gamma)
            for i in range(j + 1):
                rs[i] = tree_axpy(-alpha, us[i + 1], rs[i])
            rs[j + 1] = yield from op(rs[j])
            y = tree_axpy(alpha, us[0], y)
        # MR part: MGS of r_1..r_ℓ, r_0 projected; for each j one stacked
        # reduction gives σ_j, (r_0, r_j) and the remaining r_i's on r_j.
        tau = [[None] * (ell + 1) for _ in range(ell + 1)]
        gamma_p = [None] * (ell + 1)
        for j in range(1, ell + 1):
            dots = batched_vdot([(rs[j], rs[j]), (rs[0], rs[j])]
                                + [(rs[i], rs[j]) for i in range(j + 1, ell + 1)])
            safe = nonzero(dots[0])
            ok = ok & (dots[0].abs() > eps)
            gamma_p[j] = dots[1] / safe
            for idx, i in enumerate(range(j + 1, ell + 1)):
                tau[j][i] = dots[2 + idx] / safe
                rs[i] = tree_axpy(-tau[j][i], rs[j], rs[i])
        # Back-substitute the polynomial's coefficients.
        gam = [None] * (ell + 1)
        gam[ell] = gamma_p[ell]
        for j in range(ell - 1, 0, -1):
            acc = gamma_p[j]
            for i in range(j + 1, ell + 1):
                acc = acc - tau[j][i] * gam[i]
            gam[j] = acc
        gam_pp = [None] * ell
        for j in range(1, ell):
            acc = gam[j + 1]
            for i in range(j + 1, ell):
                acc = acc + tau[j][i] * gam[i + 1]
            gam_pp[j] = acc
        omega = gam[ell]
        y = tree_axpy(gam[1], rs[0], y)
        for j in range(1, ell):
            y = tree_axpy(gam_pp[j], rs[j], y)
        for j in range(1, ell + 1):
            rs[0] = tree_axpy(-gamma_p[j], rs[j], rs[0])
            us[0] = tree_axpy(-gam[j], us[j], us[0])
        if reliable:
            res_sq, y_sq = batched_vdot([(rs[0], rs[0]), (y, y)])
        else:
            res_sq = tree_vdot(rs[0], rs[0])
        res = torch.sqrt(res_sq)
        if reliable:
            drift = drift + mach_eps * (norm_A * torch.sqrt(y_sq) + res)
            crossing = below & (drift >= delta_t * res)
            read = yield Read(torch.stack([res, ok.to(dtype), crossing.to(dtype)]))
        else:
            read = yield Read(torch.stack([res, ok.to(dtype)]))
        syncs += 1
        res_f, ok_f = read[:2]
        history.append(res_f)
        if res_f < tol:
            status = int(SolverStatus.CONVERGED)
        breakdown = not math.isfinite(res_f) or (not ok_f and res_f >= tol)
        if breakdown and status != SolverStatus.CONVERGED:
            status = int(SolverStatus.BREAKDOWN)
        r, u0v = rs[0], us[0]
        if reliable:
            if (read[2] and res_f >= tol and math.isfinite(res_f)
                    and status == SolverStatus.MAX_ITERATIONS):
                r = tree_sub(r_init, (yield from op(y)))
                drift = mach_eps * (norm_A * torch.sqrt(y_sq)
                                    + torch.sqrt(tree_vdot(r, r)))
            below = drift < delta_t * res
        k += 1

    # Map through the right preconditioner and certify the true residual.
    x = (yield Apply(M, y)) if M is not None else y
    if x0 is not None:
        x = tree_axpy(1.0, x0, x)
    r_true = tree_sub(b, (yield Apply(A, x)))
    true_res = torch.sqrt(tree_vdot(r_true, r_true))
    true_f = yield Read(true_res)
    syncs += 1
    if status == SolverStatus.CONVERGED and true_f >= tol:
        status = int(SolverStatus.BREAKDOWN)
    res, res_f = (true_res, true_f) if k > 0 else (res0, res0_f)
    hist = torch.tensor(history + [res_f] * (max_iterations - k),
                        dtype=dtype, device=b.device)
    return SolveResult(x=x, iterations=k, residual=res, status=status,
                       residual_history=hist, host_syncs=syncs)
