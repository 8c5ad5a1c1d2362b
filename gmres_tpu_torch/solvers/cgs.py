"""CGS (Sonneveld 1989), conjugate gradient squared, in eager PyTorch.

Counterpart of ``gmres_tpu/solvers/cgs.py``, with the same update order,
reductions and exits. Per iteration (right preconditioning):

    β  = ρ / ρ_prev
    u  = r + β·q ;  p = u + β·(q + β·p)
    v  = A·M·p ;  σ = (r0, v) ;  α = ρ/σ
    q  = u − α·v ;  z = M·(u + q)
    x += α·z ;  r −= α·A·z
    ‖r‖², ρ_next = (r, r), (r0, r)        [one stacked reduction]

Convergence on the absolute ‖r‖₂ < tol; ``rtol`` raises the target to
max(tol, rtol·‖b‖). σ or ρ at or below ``finfo(dtype).tiny``, or a
non-finite residual, ends the run in BREAKDOWN; the exit is certified on
the true residual b − A x (a CONVERGED claim that fails it becomes
BREAKDOWN), and the history is padded past the last iteration with the
final residual, as in JAX.

One host read an iteration: ‖r‖, |σ| and |ρ_next| come back in one stacked
tensor and the host decides the status, comparing in the dtype of the
values as JAX does on the device. ``SolveResult.host_syncs`` counts the
reads: the initial residual, one per iteration, the certification, and the
target when ``rtol`` is given.

The loop is a generator of steps (``cgs_steps``): each application of A or
M and each read is a request to its runner (``solvers/requests.py``).
``cgs`` drives it on its own; ``solvers/batched.py`` drives one per lane
of a batched solve.
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


def cgs(
    A: LinearOperator,
    b: torch.Tensor,
    *,
    tol: float = 1e-9,
    max_iterations: int = 10_000,
    M: Optional[Preconditioner] = None,
    x0: Optional[torch.Tensor] = None,
    rtol: Optional[float] = None,
) -> SolveResult:
    """Solve A x = b (A nonsymmetric) by (preconditioned) CGS.

    The arguments are those of ``gmres_tpu.cgs`` (the call contract of
    ``bicgstab``); b's device is the solve's."""
    return run(cgs_steps(A, b, tol=tol, max_iterations=max_iterations, M=M, x0=x0,
                         rtol=rtol))


def cgs_steps(A, b, *, tol=1e-9, max_iterations=10_000, M=None, x0=None, rtol=None):
    """``cgs``'s solve as steps (``solvers/requests.py``), returning its
    SolveResult."""
    rdtype = b.real.dtype
    tiny = torch.finfo(rdtype).tiny
    syncs = 0
    if rtol is not None:
        nb = torch.sqrt(tree_vdot(b, b).real)
        tol = yield Read(torch.maximum(torch.as_tensor(tol, dtype=nb.dtype,
                                                       device=nb.device), rtol * nb))
        syncs += 1
    tol = _in_dtype(tol, rdtype)
    if x0 is None:
        x = tree_zeros_like(b)
        r = b
    else:
        x = x0
        r = tree_sub(b, (yield Apply(A, x0)))
    r0 = r
    q = tree_zeros_like(b)
    p = tree_zeros_like(b)

    rho = tree_vdot(r0, r)
    res0 = torch.sqrt(rho.real)
    # ρ_prev = 1 and q = p = 0 make the first iteration's β-recurrences the
    # textbook u = p = r, whatever β is.
    rho_prev = torch.ones((), dtype=rho.dtype, device=b.device)
    res0_f = yield Read(res0)
    status = int(SolverStatus.CONVERGED if res0_f < tol
                 else SolverStatus.MAX_ITERATIONS)
    syncs += 1
    history = []
    i = 0
    while i < max_iterations and status == SolverStatus.MAX_ITERATIONS:
        safe_rho_prev = torch.where(rho_prev.abs() > tiny, rho_prev,
                                    torch.ones_like(rho_prev))
        beta = rho / safe_rho_prev
        u = tree_axpy(beta, q, r)
        p = tree_axpy(beta, tree_axpy(beta, p, q), u)
        v = yield Apply(A, (yield Apply(M, p)) if M is not None else p)
        # σ = ⟨r0, v⟩, conjugate-linear in the shadow vector (JAX's choice).
        sigma = tree_vdot(r0, v)
        safe_sigma = torch.where(sigma.abs() > tiny, sigma, torch.ones_like(sigma))
        alpha = rho / safe_sigma
        q = tree_axpy(-alpha, v, u)
        uq = u + q
        z = (yield Apply(M, uq)) if M is not None else uq
        x = tree_axpy(alpha, z, x)
        r = tree_axpy(-alpha, (yield Apply(A, z)), r)
        res_sq, rho_next = batched_vdot([(r, r), (r0, r)])
        res = torch.sqrt(res_sq.real)
        res_f, sigma_abs, rho_abs = yield Read(torch.stack(
            [res, sigma.abs(), rho_next.abs()]))
        syncs += 1
        history.append(res_f)
        if res_f < tol:
            status = int(SolverStatus.CONVERGED)
        breakdown = (not math.isfinite(res_f) or sigma_abs <= tiny
                     or rho_abs <= tiny)
        if breakdown and status != SolverStatus.CONVERGED:
            status = int(SolverStatus.BREAKDOWN)
        rho_prev, rho = rho, rho_next
        i += 1

    # Certify on the true residual (one extra matvec): CGS's squared
    # polynomial makes its recursive r the least trustworthy of the family.
    r_true = tree_sub(b, (yield Apply(A, x)))
    true_res = torch.sqrt(tree_vdot(r_true, r_true).real)
    true_f = yield Read(true_res)
    syncs += 1
    if status == SolverStatus.CONVERGED and true_f >= tol:
        status = int(SolverStatus.BREAKDOWN)
    if i > 0:
        res, res_f = true_res, true_f
    else:
        res, res_f = res0, res0_f
    hist = torch.tensor(history + [res_f] * (max_iterations - i),
                        dtype=rdtype, device=b.device)
    return SolveResult(x=x, iterations=i, residual=res, status=status,
                       residual_history=hist, host_syncs=syncs)
