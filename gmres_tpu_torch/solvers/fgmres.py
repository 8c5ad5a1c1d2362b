"""Flexible GMRES (FGMRES, Saad '93): right preconditioning with a possibly
nonlinear or iteration-varying preconditioner, in eager PyTorch.

Counterpart of ``gmres_tpu/solvers/fgmres.py``, with its options and
arithmetic. The preconditioned directions z_t = M(v_t) are kept in a basis
Z of their own beside the Arnoldi basis V, and the true residual is
minimised over span(Z), so M may be an inner solve with a fixed step
budget. CGS2 orthogonalisation over the rows written so far (JAX's
zero-initialised rows contribute exact zeros), Givens on the accumulated
rotation (ops/givens.py) and the restart loop of ``solvers/gmres.py``
with no left preconditioner: the Givens estimate is the true relative
residual. ``inner_dtype`` runs the bases and the M and A applications of a
cycle in that dtype, with x, the residuals and the certification in b's.

Host reads, as in the port's ``gmres``: one boolean per inner iteration
that tests convergence, one status per restart and one for the initial
residual (``GmresResult.host_syncs``).

The loop is a generator of steps (``fgmres_steps``): each application of A
or M and each read is a request to its runner (``solvers/requests.py``).
``fgmres`` drives it on its own; ``solvers/batched.py`` drives one per
lane of a batched solve.
"""

from __future__ import annotations

from typing import Optional

import torch

from gmres_tpu_torch.ops.blas import gram, row_combine, rows_like, tree_vdot
from gmres_tpu_torch.ops.givens import givens_init, givens_step
from gmres_tpu_torch.ops.tri import masked_back_substitution
from gmres_tpu_torch.solvers.gmres import (
    _as_operator,
    _cgs_pass,
    _nonzero_or_one,
    _norm,
    _restarted_steps,
    _v_err_mgsr,
)
from gmres_tpu_torch.solvers.requests import Apply, Read, run
from gmres_tpu_torch.types import GmresResult, Preconditioner


def _solve_1x1(op, b, x0, tol) -> GmresResult:
    """The degenerate 1×1 system of the right-preconditioned solvers, solved
    directly; the residual is unpreconditioned, so M never enters it."""
    return run(_solve_1x1_steps(op, b, x0, tol))


def _solve_1x1_steps(op, b, x0, tol):
    """``_solve_1x1`` as steps (``solvers/requests.py``)."""
    a_val = yield Apply(op, torch.ones_like(b))
    singular = a_val == 0
    x = torch.where(~singular, b / torch.where(~singular, a_val, torch.ones_like(a_val)),
                    torch.zeros_like(b))
    if x0 is not None:
        x = torch.where(~singular, x, x0)
    r = b - (yield Apply(op, x))
    residual = _norm(r) / torch.clamp(_norm(b), min=torch.finfo(b.dtype).tiny)
    status = yield Read(torch.where(residual < tol, 0,
                                    torch.where(singular.reshape(()), 2, 1)))
    return GmresResult(
        x=x, iterations=1, restarts=1, residual=residual, status=status,
        residual_history=residual.reshape(1).to(b.dtype).clone(),
        v_err=torch.zeros((2,), dtype=b.dtype, device=b.device), host_syncs=1,
    )


def fgmres(
    A,
    b: torch.Tensor,
    *,
    restart: int = 30,
    tol: float = 1e-8,
    max_restarts: int = 1000,
    M: Optional[Preconditioner] = None,
    inner_dtype=None,
    x0: Optional[torch.Tensor] = None,
    compute_v_err: bool = False,
    breakdown_check: bool = True,
) -> GmresResult:
    """Solve A x = b by restarted FGMRES(restart) (the arguments of
    ``gmres_tpu.fgmres``).

      M: right preconditioner applied to each Arnoldi vector, z_t = M(v_t);
        may be nonlinear or iteration-varying. None is plain GMRES.
      inner_dtype: torch dtype of the cycle's bases and applications;
        convergence is then certified by the true residual in b's dtype at
        restart boundaries.
      compute_v_err: orthogonality audit of V (the MGSR variant's metric).
      breakdown_check: exit a cycle on lucky breakdown h_val < tol.
    """
    return run(fgmres_steps(A, b, restart=restart, tol=tol, max_restarts=max_restarts,
                            M=M, inner_dtype=inner_dtype, x0=x0,
                            compute_v_err=compute_v_err, breakdown_check=breakdown_check))


def fgmres_steps(A, b, *, restart=30, tol=1e-8, max_restarts=1000, M=None,
                 inner_dtype=None, x0=None, compute_v_err=False, breakdown_check=True):
    """``fgmres``'s solve as steps (``solvers/requests.py``), returning its
    GmresResult."""
    op = _as_operator(A, b.device)
    if b.numel() == 1:
        return (yield from _solve_1x1_steps(op, b, x0, tol))
    if x0 is None:
        x0 = torch.zeros_like(b)
    dtype = b.dtype
    dev = b.device
    shape = b.shape
    m = min(restart, b.numel() - 1)
    work_dtype = inner_dtype if inner_dtype is not None else dtype
    mixed = work_dtype != dtype
    tiny = torch.finfo(dtype).tiny
    inner_gain = float(torch.finfo(work_dtype).eps) * 10.0

    def cycle(x, r, beta, beta0, rel_prev):
        # rel_prev is unused: right preconditioning keeps the Givens
        # estimate in the true residual's norm.
        del rel_prev
        bsafe = _nonzero_or_one(beta)
        v_basis = rows_like(m + 1, b, work_dtype)
        v_basis[0] = (r / bsafe).to(work_dtype)
        z_basis = rows_like(m, b, work_dtype)
        g0 = torch.zeros((m + 1,), dtype=dtype, device=dev)
        g0[0] = beta
        giv = givens_init(m, g0)._replace(beta0=torch.clamp(beta0, min=tiny).to(dtype))
        hmat = torch.zeros((m + 1, m), dtype=dtype, device=dev)
        ferr = torch.zeros((m,), dtype=dtype, device=dev)
        if mixed:
            inner_floor = torch.clamp((beta / torch.clamp(beta0, min=tiny)) * inner_gain,
                                      min=tol)
        else:
            inner_floor = tol

        syncs = 0
        t = 0
        while True:
            # M's output cast once, the same value stored and given to A.
            z_t = ((yield Apply(M, v_basis[t])) if M is not None
                   else v_basis[t]).to(work_dtype)
            z_basis[t] = z_t
            w = (yield Apply(op, z_t)).to(work_dtype)
            h1, w = _cgs_pass(v_basis[: t + 1], w)
            h2, w = _cgs_pass(v_basis[: t + 1], w)
            h_val = torch.sqrt(tree_vdot(w, w))
            hcol = torch.zeros((m + 1,), dtype=dtype, device=dev)
            hcol[: t + 1] = (h1 + h2).to(dtype)
            hcol[t + 1] = h_val.to(dtype)
            giv, col, g_next = givens_step(giv, hcol, t)
            hmat[:, t] = col
            rel = g_next.abs() / giv.beta0
            ferr[t] = rel
            v_basis[t + 1] = w / _nonzero_or_one(h_val)
            t += 1
            if t >= m:
                break
            converged = rel < inner_floor
            if breakdown_check:
                converged = converged | (h_val.to(dtype) < tol)
            syncs += 1
            if (yield Read(converged)):
                break
        n_out = t
        y = masked_back_substitution(hmat, giv.g, n_out)
        # x += Z y (β-normalised before the work-dtype cast).
        dx = row_combine((y / bsafe).to(work_dtype), z_basis)
        x = x + bsafe * dx.to(dtype)
        return x, n_out, ferr, h_val.to(dtype), v_basis, syncs

    x, k, n_out, ferr, v_basis, status, residual, syncs = yield from _restarted_steps(
        cycle, op, b, x0, m, tol, max_restarts, None, mixed,
        breakdown_check=breakdown_check, certify_true=False,
        work_dtype=work_dtype,
    )
    if compute_v_err and v_basis is not None:
        v_err = _v_err_mgsr(gram(v_basis, v_basis).to(dtype), n_out, dtype)
    else:
        v_err = torch.zeros((m + 1,), dtype=dtype, device=dev)
    return GmresResult(
        x=x, iterations=n_out, restarts=k, residual=residual, status=status,
        residual_history=ferr, v_err=v_err, host_syncs=syncs,
    )
