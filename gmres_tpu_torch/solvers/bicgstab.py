"""BiCGSTAB (van der Vorst) for nonsymmetric systems, with optional
right-applied preconditioning in the reference's style, in eager PyTorch.

Counterpart of ``gmres_tpu/solvers/bicgstab.py``, with the same update
order, reductions and exits. Per iteration:

    z1 = M⁻¹p ; ap = A z1 ; α = (r,r0) / (ap,r0)
    s  = r − α·ap ; z2 = M⁻¹s ; as = A z2
    ω  = (as,s) / (as,as)                  [one stacked reduction]
    x += ω·z2 + α·z1 ; r = s − ω·as
    ‖r‖², (r,r0) [, ‖x‖²]                  [one stacked reduction]
    β  = ((r,r0)/rr0)(α/ω) ; p = r + β(p − ω·ap)

* Convergence on the ABSOLUTE ‖r‖₂ < tol; ``rtol`` raises the target to
  max(tol, rtol·‖b‖). The thresholds are JAX's: the degeneracy and
  breakdown tests use ``finfo(dtype).tiny``, the drift bound ``.eps``.
* The half-step degeneracy guard (ω = 0 when (as,as) ≤ tiny), the
  breakdown tests, van der Vorst–Ye residual replacement (``reliable``,
  threshold ``replace_delta``), the exit certification on the true
  residual and the history padded past the last iteration are JAX's.

``lax.while_loop`` becomes a Python loop with one host read per iteration:
‖r‖, (r,r0), (as,as) and the device half of the replacement trigger
(below the δ·‖r‖ threshold before, at or above it now) come back in one
stacked tensor, and the host decides the status and the trigger in the
dtype of the values, as JAX does on the device. ``lax.cond(trigger,
replace, …)`` is a Python branch on that read, so a replacement costs its
matvec and no extra read. ``SolveResult.host_syncs`` counts the reads: the
initial residual, one per iteration, the final certification, and the
target when ``rtol`` is given.

The loop is a generator of steps (``bicgstab_steps``): each application of
A or M and each read is a request to its runner (``solvers/requests.py``).
``bicgstab`` drives it on its own; ``solvers/batched.py`` drives one per
lane of a batched solve.
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


def bicgstab(
    A: LinearOperator,
    b: torch.Tensor,
    *,
    tol: float = 1e-9,
    max_iterations: int = 10_000,
    M: Optional[Preconditioner] = None,
    x0: Optional[torch.Tensor] = None,
    reliable: bool = True,
    replace_delta: Optional[float] = None,
    rtol: Optional[float] = None,
) -> SolveResult:
    """Solve A x = b (A nonsymmetric) by (preconditioned) BiCGSTAB.

    The arguments are those of ``gmres_tpu.bicgstab``: A and M are
    callables on tensors shaped like b (b's device is the solve's); x0
    defaults to zeros; tol is the absolute ‖r‖₂ target and rtol, when
    given, raises it to max(tol, rtol·‖b‖).

    reliable: van der Vorst–Ye residual replacement. A drift bound
      d += ε·(‖A‖‖x‖ + ‖r‖) accumulates each iteration (‖A‖ from one probe
      A r0 before the loop); when it first crosses δ·‖r‖ the recursive r
      is replaced by b − A x (one matvec) and the bound resets.
    replace_delta: the threshold δ (default √ε of the dtype).
    """
    return run(bicgstab_steps(A, b, tol=tol, max_iterations=max_iterations, M=M,
                              x0=x0, reliable=reliable,
                              replace_delta=replace_delta, rtol=rtol))


def bicgstab_steps(A, b, *, tol=1e-9, max_iterations=10_000, M=None, x0=None,
                   reliable=True, replace_delta=None, rtol=None):
    """``bicgstab``'s solve as steps (``solvers/requests.py``), returning
    its SolveResult."""
    rdtype = b.real.dtype
    finfo = torch.finfo(rdtype)
    tiny, mach_eps = finfo.tiny, finfo.eps
    delta = (float(replace_delta) if replace_delta is not None
             else mach_eps ** 0.5)
    syncs = 0
    if rtol is not None:
        nb = torch.sqrt(tree_vdot(b, b).real)
        tol = yield Read(torch.maximum(torch.as_tensor(tol, dtype=nb.dtype,
                                                       device=nb.device), rtol * nb))
        syncs += 1
    tol = _in_dtype(tol, rdtype)
    # The thresholds as JAX compares them: tiny and δ·‖r‖ in the dtype.
    delta_t = _in_dtype(delta, rdtype)
    if x0 is None:
        x = tree_zeros_like(b)
        r = b
    else:
        x = x0
        r = tree_sub(b, (yield Apply(A, x0)))
    r0 = r
    p = r
    zero = torch.zeros((), dtype=rdtype, device=b.device)
    if reliable:
        # ‖A‖ scale for the drift bound: one Rayleigh-style probe on r0.
        ar0 = yield Apply(A, r0)
        norm_A = torch.sqrt(tree_vdot(ar0, ar0).real
                            / torch.clamp(tree_vdot(r0, r0).real, min=tiny))

    rr0 = tree_vdot(r, r0)
    res = torch.sqrt(rr0.real)
    # Already converged at x0 (e.g. b = 0): skip the loop.
    status = int(SolverStatus.CONVERGED if (yield Read(res)) < tol
                 else SolverStatus.MAX_ITERATIONS)
    syncs += 1
    drift = zero
    below = torch.ones((), dtype=torch.bool, device=b.device)
    history = []
    i = 0
    while i < max_iterations and status == SolverStatus.MAX_ITERATIONS:
        z1 = (yield Apply(M, p)) if M is not None else p
        ap = yield Apply(A, z1)
        alpha = rr0 / tree_vdot(ap, r0)
        s = tree_axpy(-alpha, ap, r)
        z2 = (yield Apply(M, s)) if M is not None else s
        as_ = yield Apply(A, z2)
        as_s, as_as = batched_vdot([(as_, s), (as_, as_)])
        # Half-step degeneracy guard (JAX's :123-140): s ≈ 0 makes ω 0/0.
        degenerate = as_as.real <= tiny
        omega = torch.where(degenerate, zero.to(as_s.dtype),
                            as_s / torch.where(as_as.real > 0, as_as,
                                               torch.ones_like(as_as)))
        x = tree_axpy(alpha, z1, tree_axpy(omega, z2, x))
        r = tree_axpy(-omega, as_, s)
        if reliable:
            res_sq, r_r0_new, x_sq = batched_vdot([(r, r), (r, r0), (x, x)])
        else:
            res_sq, r_r0_new = batched_vdot([(r, r), (r, r0)])
        res = torch.sqrt(res_sq.real)
        safe_omega = torch.where(omega != 0, omega, torch.ones_like(omega))
        beta = (r_r0_new / rr0) * (alpha / safe_omega)
        p = tree_axpy(beta, tree_axpy(-omega, ap, p), r)
        rr0_next = r_r0_new
        if reliable:
            drift = drift + mach_eps * (norm_A * torch.sqrt(x_sq.real) + res)
            crossing = below & (drift >= delta_t * res)
            read = yield Read(torch.stack([res, r_r0_new.abs(), as_as.real,
                                           crossing.to(rdtype)]))
        else:
            read = yield Read(torch.stack([res, r_r0_new.abs(), as_as.real]))
        syncs += 1
        res_f, rr0_abs, as_as_f = read[:3]
        history.append(res_f)
        if res_f < tol:
            status = int(SolverStatus.CONVERGED)
        breakdown = (not math.isfinite(res_f)
                     or (as_as_f <= tiny and res_f >= tol)
                     or rr0_abs <= tiny)
        if breakdown and status != SolverStatus.CONVERGED:
            status = int(SolverStatus.BREAKDOWN)
        if reliable:
            # Replace only at a crossing of δ·‖r‖ (JAX's :196-210), after
            # the iteration's updates (the p-update used the old (r, r0)).
            if (read[3] and res_f >= tol and math.isfinite(res_f)
                    and status == SolverStatus.MAX_ITERATIONS):
                r = tree_sub(b, (yield Apply(A, x)))
                res_t_sq, rr0_next = batched_vdot([(r, r), (r, r0)])
                drift = mach_eps * (norm_A * torch.sqrt(x_sq.real)
                                    + torch.sqrt(res_t_sq.real))
            below = drift < delta_t * res
        rr0 = rr0_next
        i += 1

    # Certify on the true residual (one extra matvec): a CONVERGED claim
    # that fails re-verification downgrades to BREAKDOWN, and once an
    # iteration ran the true norm is reported.
    r_true = tree_sub(b, (yield Apply(A, x)))
    true_res = torch.sqrt(tree_vdot(r_true, r_true).real)
    true_f = yield Read(true_res)
    syncs += 1
    if status == SolverStatus.CONVERGED and true_f >= tol:
        status = int(SolverStatus.BREAKDOWN)
    if i > 0:
        res, res_f = true_res, true_f
    else:
        res_f = yield Read(res)
    hist = torch.tensor(history + [res_f] * (max_iterations - i),
                        dtype=rdtype, device=b.device)
    return SolveResult(x=x, iterations=i, residual=res, status=status,
                       residual_history=hist, host_syncs=syncs)
