"""Communication-avoiding (s-step) GMRES, in eager PyTorch.

Counterpart of ``gmres_tpu/solvers/sstep.py``, with its options and
arithmetic. A cycle generates the monomial Krylov block
Z = [z₀, B z₀, …, Bˢ z₀] with B = M∘A (s operator applications and no
reduction), takes the (s+1)² Gram Z Zᵀ in one product, equilibrates its
lower block by its diagonal, adds the ridge and solves min‖w − β Z₁ y‖ by
Cholesky; x ← x + β Z₀ y; then the true preconditioned residual is
recomputed and certifies the cycle. ``inner_dtype`` generates the block in
that dtype; the Gram (its products accumulated in b's dtype), its solve,
the x update and the certification run in b's.

``lax.while_loop`` becomes a Python loop that reads the device once per
cycle (the convergence and stagnation flags together) and once for the
initial residual; ``GmresResult.host_syncs`` counts them.

The loop is a generator of steps (``sstep_gmres_steps``): each application
of A or M and each read is a request to its runner
(``solvers/requests.py``). ``sstep_gmres`` drives it on its own;
``solvers/batched.py`` drives one per lane of a batched solve.
"""

from __future__ import annotations

from typing import Optional

import torch

from gmres_tpu_torch.ops.blas import gram as block_gram, row_combine, tree_vdot
from gmres_tpu_torch.solvers.gmres import _as_operator, _nonzero_or_one
from gmres_tpu_torch.solvers.requests import Apply, Read, run
from gmres_tpu_torch.types import GmresResult, Preconditioner, SolverStatus


def sstep_gmres(
    A,
    b: torch.Tensor,
    *,
    s: int = 8,
    tol: float = 1e-8,
    max_restarts: int = 1000,
    M: Optional[Preconditioner] = None,
    x0: Optional[torch.Tensor] = None,
    inner_dtype=None,
    rel_ridge: float = 0.0,
) -> GmresResult:
    """Solve A x = b by restarted s-step GMRES (the arguments of
    ``gmres_tpu.sstep_gmres``).

      s: Krylov block size per cycle (the restart length).
      tol: relative tolerance on the true preconditioned residual
        ‖M(b − A x)‖/‖b‖, checked at each cycle's end.
      M: left preconditioner; a deep Chebyshev one keeps the monomial
        basis well conditioned.
      inner_dtype: torch dtype of the block generation; None = b's dtype.
      rel_ridge: Tikhonov ridge on the equilibrated Gram's unit diagonal;
        0 selects 100·eps of the work dtype.
    """
    return run(sstep_gmres_steps(A, b, s=s, tol=tol, max_restarts=max_restarts, M=M,
                                 x0=x0, inner_dtype=inner_dtype, rel_ridge=rel_ridge))


def sstep_gmres_steps(A, b, *, s=8, tol=1e-8, max_restarts=1000, M=None, x0=None,
                      inner_dtype=None, rel_ridge=0.0):
    """``sstep_gmres``'s solve as steps (``solvers/requests.py``), returning
    its GmresResult."""
    op = _as_operator(A, b.device)
    if x0 is None:
        x0 = torch.zeros_like(b)
    dtype = b.dtype
    dev = b.device
    shape = b.shape
    work_dtype = inner_dtype if inner_dtype is not None else dtype
    tiny = torch.finfo(dtype).tiny
    ridge = (rel_ridge if rel_ridge > 0.0
             else 100.0 * float(torch.finfo(work_dtype).eps))

    beta0 = torch.sqrt(tree_vdot(b, b))

    def precond_residual(x):
        r = b - (yield Apply(op, x))
        w = (yield Apply(M, r)) if M is not None else r
        return w, torch.sqrt(tree_vdot(w, w))

    def apply_b(v):
        z = yield Apply(op, v)
        return (yield Apply(M, z)) if M is not None else z

    def cycle(x, w, beta):
        z0 = (w / _nonzero_or_one(beta)).to(work_dtype)
        zs = [z0]
        for _ in range(s):
            zs.append((yield from apply_b(zs[-1])).to(work_dtype))
        z_full = torch.stack(zs)  # (s+1, *shape)
        # The products of a float32 block accumulate in b's dtype: torch's
        # float32 GEMM sums this (s+1) × n × (s+1) product less accurately
        # than XLA's (1.4e-6 against 3.2e-7 relative at 512², on the CPU),
        # enough to make the equilibrated Gram indefinite past its ridge.
        zf = z_full.to(dtype)
        gram = block_gram(zf, zf)
        g_mat = gram[1:, 1:]
        c_vec = gram[1:, 0]
        d = 1.0 / torch.sqrt(torch.clamp(torch.diagonal(g_mat), min=tiny))
        g_scaled = g_mat * d[:, None] * d[None, :]
        g_scaled = g_scaled + ridge * torch.eye(s, dtype=dtype, device=dev)
        chol, info = torch.linalg.cholesky_ex(g_scaled)
        y = torch.linalg.solve_triangular(chol, (d * c_vec)[:, None], upper=False)
        y = d * torch.linalg.solve_triangular(chol.T, y, upper=True)[:, 0]
        # A failed factorisation gives NaN in JAX: skip the update.
        y_ok = (info == 0) & torch.isfinite(y).all()
        y = torch.where(y_ok, y, torch.zeros_like(y))
        dx = row_combine(y.to(work_dtype), z_full[:s]).reshape(shape)
        x = x + beta * dx.to(dtype)
        # ‖w − βZ₁y‖² = β²(1 − 2yᵀc + yᵀGy), with no extra reduction.
        est_sq = 1.0 - 2.0 * (y @ c_vec) + y @ (g_mat @ y)
        est = beta * torch.sqrt(torch.clamp(est_sq, min=0.0))
        return x, est, y_ok

    w, beta = yield from precond_residual(x0)
    rel = beta / torch.clamp(beta0, min=tiny)
    converged = yield Read((beta0 == 0) | (rel < tol))
    syncs = 1
    stalled = False
    hist = torch.zeros((max_restarts,), dtype=dtype, device=dev)
    x, k = x0, 0
    while k < max_restarts and not converged and not stalled:
        x_new, est, y_ok = yield from cycle(x, w, beta)
        w_new, beta_new = yield from precond_residual(x_new)
        rel = beta_new / torch.clamp(beta0, min=tiny)
        conv = rel < tol
        hist[k] = rel
        stall = (~y_ok) | (~torch.isfinite(beta_new)) | (
            (beta_new >= beta) & (k > 0) & (est >= beta))
        converged, stalled = yield Read(torch.stack([conv, stall & ~conv]))
        syncs += 1
        x, k, w, beta = x_new, k + 1, w_new, beta_new
    # Padded past the final cycle with the final residual.
    hist[k:] = rel
    if converged:
        status = SolverStatus.CONVERGED
    elif stalled:
        status = SolverStatus.BREAKDOWN
    else:
        status = SolverStatus.MAX_ITERATIONS
    return GmresResult(
        x=x, iterations=s if k > 0 else 0, restarts=k, residual=rel,
        status=int(status), residual_history=hist,
        v_err=torch.zeros((s + 1,), dtype=dtype, device=dev), host_syncs=syncs,
    )
