"""LGMRES, GMRES with augmented restarts (Baker, Jessup & Manteuffel, SIMAX
2005), in eager PyTorch.

Counterpart of ``gmres_tpu/solvers/lgmres.py``, with its options and
arithmetic. One cycle is m flexible Krylov steps (fgmres.py's) followed by
up to ``aug`` steps that append the last outer corrections z_i = x_i −
x_{i−1}; their images A z_i come free from the boundary residuals
(A Δx = r_prev − r_new) and are kept ‖A z‖-normalised in b's dtype in a
circular buffer. A dependent augmentation direction (CGS2 remainder below
100·eps of the work dtype) gets a zero basis slot and subdiagonal, and the
lucky-breakdown exit applies to Krylov steps only. ``aug=0`` is restarted
FGMRES.

Host reads: one boolean per inner iteration that tests convergence, one
per restart (the status and whether the new pair was kept, together) and
one for the initial residual (``GmresResult.host_syncs``).

The loop is a generator of steps (``lgmres_steps``): each application of A
or M and each read is a request to its runner (``solvers/requests.py``).
``lgmres`` drives it on its own; ``solvers/batched.py`` drives one per
lane of a batched solve.
"""

from __future__ import annotations

from typing import Optional

import torch

from gmres_tpu_torch.ops.blas import gram, row_combine, rows_like, tree_vdot
from gmres_tpu_torch.ops.givens import givens_init, givens_step
from gmres_tpu_torch.ops.tri import masked_back_substitution
from gmres_tpu_torch.solvers.fgmres import _solve_1x1_steps
from gmres_tpu_torch.solvers.gmres import (
    _as_operator,
    _cgs_pass,
    _nonzero_or_one,
    _v_err_mgsr,
)
from gmres_tpu_torch.solvers.requests import Apply, Read, run
from gmres_tpu_torch.types import GmresResult, Preconditioner, SolverStatus


def lgmres(
    A,
    b: torch.Tensor,
    *,
    restart: int = 30,
    aug: int = 3,
    tol: float = 1e-8,
    max_restarts: int = 1000,
    M: Optional[Preconditioner] = None,
    inner_dtype=None,
    x0: Optional[torch.Tensor] = None,
    compute_v_err: bool = False,
) -> GmresResult:
    """Solve A x = b by LGMRES(restart, aug) (the arguments of
    ``gmres_tpu.lgmres``).

      restart: Krylov dimension m per cycle (the cycle's subspace is
        m + aug).
      aug: previous outer corrections appended per cycle; 0 is FGMRES.
      M: right preconditioner (may be nonlinear, as in ``fgmres``).
      inner_dtype: torch dtype of the cycle; convergence is then certified
        on the true residual in b's dtype.
      compute_v_err: orthogonality audit of the last cycle's V basis.
    """
    return run(lgmres_steps(A, b, restart=restart, aug=aug, tol=tol,
                            max_restarts=max_restarts, M=M, inner_dtype=inner_dtype,
                            x0=x0, compute_v_err=compute_v_err))


def lgmres_steps(A, b, *, restart=30, aug=3, tol=1e-8, max_restarts=1000, M=None,
                 inner_dtype=None, x0=None, compute_v_err=False):
    """``lgmres``'s solve as steps (``solvers/requests.py``), returning its
    GmresResult."""
    op = _as_operator(A, b.device)
    if b.numel() == 1:
        return (yield from _solve_1x1_steps(op, b, x0, tol))
    if x0 is None:
        x0 = torch.zeros_like(b)
    dtype = b.dtype
    dev = b.device
    shape = tuple(b.shape)
    m = min(restart, b.numel() - 1)
    k_aug = max(int(aug), 0)
    s = m + k_aug
    work_dtype = inner_dtype if inner_dtype is not None else dtype
    mixed = work_dtype != dtype
    tiny = torch.finfo(dtype).tiny
    eps_work = float(torch.finfo(work_dtype).eps)
    beta0 = torch.sqrt(tree_vdot(b, b))
    inner_gain = eps_work * 10.0

    def cycle(r, beta, aug_z, aug_w, n_aug):
        bsafe = _nonzero_or_one(beta)
        v_basis = rows_like(s + 1, b, work_dtype)
        v_basis[0] = (r / bsafe).to(work_dtype)
        z_basis = rows_like(s, b, work_dtype)
        g0 = torch.zeros((s + 1,), dtype=dtype, device=dev)
        g0[0] = beta
        giv = givens_init(s, g0)._replace(beta0=torch.clamp(beta0, min=tiny))
        hmat = torch.zeros((s + 1, s), dtype=dtype, device=dev)
        ferr = torch.zeros((s,), dtype=dtype, device=dev)
        if mixed:
            inner_floor = torch.clamp((beta / torch.clamp(beta0, min=tiny)) * inner_gain,
                                      min=tol)
        else:
            inner_floor = tol
        hb = torch.ones((), dtype=dtype, device=dev)

        syncs = 0
        t = 0
        while True:
            is_krylov = t < m
            if is_krylov:
                z_t = ((yield Apply(M, v_basis[t])) if M is not None
                       else v_basis[t]).to(work_dtype)
                w = (yield Apply(op, z_t)).to(work_dtype)
            else:
                z_t = aug_z[t - m].to(work_dtype)
                w = aug_w[t - m].to(work_dtype)
            z_basis[t] = z_t
            h1, w = _cgs_pass(v_basis[: t + 1], w)
            h2, w = _cgs_pass(v_basis[: t + 1], w)
            h_val = torch.sqrt(tree_vdot(w, w))
            # A dependent augmentation direction: a zero basis slot and
            # subdiagonal instead of normalised CGS2 noise.
            if is_krylov:
                h_sub, v_next = h_val, w / _nonzero_or_one(h_val)
            else:
                dependent = h_val.to(dtype) < 100.0 * eps_work
                h_sub = torch.where(dependent, torch.zeros_like(h_val), h_val)
                v_next = torch.where(dependent, torch.zeros_like(w),
                                     w / _nonzero_or_one(h_val))
            hcol = torch.zeros((s + 1,), dtype=dtype, device=dev)
            hcol[: t + 1] = (h1 + h2).to(dtype)
            hcol[t + 1] = h_sub.to(dtype)
            giv, col, g_next = givens_step(giv, hcol, t)
            hmat[:, t] = col
            rel = g_next.abs() / giv.beta0
            ferr[t] = rel
            v_basis[t + 1] = v_next
            converged = rel < inner_floor
            if is_krylov:
                # Lucky breakdown ends a cycle on Krylov steps only.
                converged = converged | (h_val.to(dtype) < tol)
                hb = h_val.to(dtype)
            t += 1
            if t >= m + n_aug:
                break
            syncs += 1
            if (yield Read(converged)):
                break
        y = masked_back_substitution(hmat, giv.g, t)
        dx = row_combine((y / bsafe).to(work_dtype), z_basis)
        return bsafe * dx.to(dtype), t, ferr, hb, v_basis, syncs

    def true_residual(x):
        r = b - (yield Apply(op, x))
        beta = torch.sqrt(tree_vdot(r, r))
        return r, beta, beta / torch.clamp(beta0, min=tiny)

    r, beta, rel_init = yield from true_residual(x0)
    converged = yield Read((beta0 == 0) | (rel_init < tol))
    syncs = 1
    breakdown = False
    buf = max(k_aug, 1)
    aug_z = rows_like(buf, b)
    aug_w = rows_like(buf, b)
    x, k, n_out, n_aug = x0, 0, 0, 0
    ferr = torch.zeros((s,), dtype=dtype, device=dev)
    v_basis = None
    while k < max_restarts and not converged and not breakdown:
        dx, n_out, ferr, hb, v_basis, inner_syncs = yield from cycle(
            r, beta, aug_z, aug_w, n_aug)
        syncs += inner_syncs
        x = x + dx
        r_new, beta, rel_new = yield from true_residual(x)
        last = max(n_out - 1, 0)
        # Right preconditioning: the Givens estimate is the true relative
        # residual; mixed mode certifies on the recomputed one.
        conv = rel_new < tol if mixed else ferr[last] < tol
        bd = ((hb < tol) & ~conv) | ~torch.isfinite(beta)
        flags = [conv, bd]
        if k_aug > 0:
            az = r - r_new
            az_norm = torch.sqrt(tree_vdot(az, az))
            ok = (az_norm > 0) & torch.isfinite(az_norm)
            flags.append(ok)
        flags = yield Read(torch.stack(flags))
        syncs += 1
        converged, breakdown = flags[0], flags[1]
        if k_aug > 0 and flags[2]:
            aug_z = torch.roll(aug_z, 1, 0)
            aug_w = torch.roll(aug_w, 1, 0)
            aug_z[0] = dx / az_norm
            aug_w[0] = az / az_norm
            n_aug = min(n_aug + 1, k_aug)
        if mixed:
            ferr[last] = rel_new
        r, k = r_new, k + 1

    if converged:
        status = SolverStatus.CONVERGED
    elif breakdown:
        status = SolverStatus.BREAKDOWN
    else:
        status = SolverStatus.MAX_ITERATIONS
    if k > 0:
        residual = ferr[max(n_out - 1, 0)].clone()
    elif mixed:
        residual = rel_init
    else:
        residual = beta / torch.clamp(beta0, min=tiny)
    if compute_v_err and v_basis is not None:
        v_err = _v_err_mgsr(gram(v_basis, v_basis).to(dtype), n_out, dtype)
    else:
        v_err = torch.zeros((s + 1,), dtype=dtype, device=dev)
    return GmresResult(
        x=x, iterations=n_out, restarts=k, residual=residual, status=int(status),
        residual_history=ferr, v_err=v_err, host_syncs=syncs,
    )
