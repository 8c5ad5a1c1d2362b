"""Block GMRES: restarted GMRES for s right-hand sides at once, in eager
PyTorch.

Counterpart of ``gmres_tpu/solvers/block_gmres.py``, with its options and
arithmetic: one cycle is exactly m block-Arnoldi steps; block CGS2 between
blocks (two contractions with the rows written so far), SVQB twice within
a block (an s×s Gram, ``eigh`` and a scaled combination, with the
eigenvalue clamp that absorbs rank-deficient blocks); the block least
squares by a dense QR of the ((m+1)s, ms) matrix; M linear and on the
right, applied once to the combined correction.

JAX batches the single-vector operator and preconditioner with
``jax.vmap``, which adds a grid axis to a Pallas kernel. Here each is
``ops/blas.py:row_apply`` (``torch.func.vmap`` over the s rows: on the card
one launch of each kernel on the path for all rows).

The solve is a generator of steps (``block_gmres_steps``,
``solvers/requests.py``): ``block_gmres`` drives it on its own,
``solvers/batched.py`` one a lane, each lane a block (a block application
of every lane one nested vmap).

Host reads: the initial residuals and one per restart cycle
(``BlockSolveResult.host_syncs``).
"""

from __future__ import annotations

from typing import Optional

import torch

from gmres_tpu_torch.ops.blas import (
    _orthonormalize_block,
    as_plain,
    replicate_like,
    rows_like,
)
from gmres_tpu_torch.solvers.gmres import _as_operator
from gmres_tpu_torch.solvers.requests import Apply, Read, rows, run
from gmres_tpu_torch.types import BlockSolveResult, Preconditioner, SolverStatus


def block_gmres(
    A,
    B: torch.Tensor,
    *,
    restart: int = 30,
    tol: float = 1e-8,
    max_restarts: int = 100,
    M: Optional[Preconditioner] = None,
    x0: Optional[torch.Tensor] = None,
) -> BlockSolveResult:
    """Solve A x_i = b_i for the s stacked right-hand sides B[i] (the
    arguments of ``gmres_tpu.block_gmres``).

      A: single-vector operator (applied row by row) or dense (n, n) matrix.
      B: (s, *shape) stacked right-hand sides.
      restart: block-Krylov cycle length m (subspace dimension m·s).
      tol: per-RHS relative true-residual tolerance; the solve stops when
        every RHS meets it (checked at restart boundaries).
      M: linear right preconditioner (single-vector callable).
      x0: optional (s, *shape) initial guesses.
    """
    return run(block_gmres_steps(A, B, restart=restart, tol=tol,
                                 max_restarts=max_restarts, M=M, x0=x0))


def block_gmres_steps(A, B, *, restart=30, tol=1e-8, max_restarts=100, M=None,
                      x0=None):
    """``block_gmres``'s solve as steps (``solvers/requests.py``), returning
    its BlockSolveResult: each block application one request
    (``requests.rows``; in a batched solve one nested vmap, each lane a
    block)."""
    op1 = _as_operator(A, B.device)
    s = B.shape[0]
    dtype = B.dtype
    dev = B.device
    m = max(int(restart), 1)
    eps = float(torch.finfo(dtype).eps)
    tiny = torch.finfo(dtype).tiny

    def vop(v):
        return (yield Apply(rows(op1), v))

    def vprec(v):
        return (yield Apply(rows(M), v)) if M is not None else v

    if x0 is None:
        x0 = torch.zeros_like(B)
    bnorms = torch.sqrt(as_plain(torch.sum(B.reshape(s, -1) ** 2, dim=1)))
    bsafe = torch.clamp(bnorms, min=tiny)

    def residual_block(x):
        r = B - (yield from vop(x))
        return r, torch.sqrt(as_plain(torch.sum(r.reshape(s, -1) ** 2, dim=1))) / bsafe

    def cycle(r):
        """m block-Arnoldi steps; returns the block correction."""
        v0, b0 = _orthonormalize_block(r, eps)
        basis = rows_like(m + 1, B)
        basis[0] = v0
        hmat = torch.zeros(((m + 1) * s, m * s), dtype=dtype, device=dev)
        for t in range(m):
            w = yield from vop((yield from vprec(basis[t])))
            v2 = basis[: t + 1].reshape(t + 1, s, -1)
            w2 = w.reshape(s, -1)
            h1 = as_plain(torch.tensordot(v2, w2, dims=([2], [1])))  # (t+1, s, s)
            w2 = w2 - torch.tensordot(replicate_like(h1, v2), v2, dims=([0, 1], [0, 1]))
            h2 = as_plain(torch.tensordot(v2, w2, dims=([2], [1])))
            w2 = w2 - torch.tensordot(replicate_like(h2, v2), v2, dims=([0, 1], [0, 1]))
            q, hsub = _orthonormalize_block(w2.reshape(B.shape), eps)
            basis[t + 1] = q
            col = torch.zeros((m + 1, s, s), dtype=dtype, device=dev)
            col[: t + 1] = h1 + h2
            col[t + 1] = hsub
            hmat[:, t * s:(t + 1) * s] = col.reshape((m + 1) * s, s)
        # Block least squares min‖E₁B₀ − H̄Y‖_F by a dense QR.
        c = torch.zeros(((m + 1) * s, s), dtype=dtype, device=dev)
        c[:s] = b0
        qh, rh = torch.linalg.qr(hmat)
        rhs = qh.T @ c
        diag = torch.diagonal(rh)
        dfloor = eps * torch.clamp(diag.abs().max(), min=1.0)
        dsafe = torch.where(diag.abs() > dfloor, diag, torch.ones_like(diag))
        rh = rh - torch.diag(diag) + torch.diag(dsafe)
        y = torch.linalg.solve_triangular(rh, rhs, upper=True)
        v_m = basis[:m].reshape(m, s, -1)
        combo = torch.tensordot(replicate_like(y.reshape(m, s, s), v_m), v_m,
                                dims=([0, 1], [0, 1])).reshape(B.shape)
        return (yield from vprec(combo))

    r, rel = yield from residual_block(x0)
    converged = yield Read(torch.all(rel < tol) | torch.all(bnorms == 0))
    syncs = 1
    breakdown = False
    x, k = x0, 0
    while k < max_restarts and not converged and not breakdown:
        x = x + (yield from cycle(r))
        r, rel = yield from residual_block(x)
        converged, breakdown = yield Read(torch.stack(
            [torch.all(rel < tol), ~torch.all(torch.isfinite(rel))]))
        syncs += 1
        k += 1
    if converged:
        status = SolverStatus.CONVERGED
    elif breakdown:
        status = SolverStatus.BREAKDOWN
    else:
        status = SolverStatus.MAX_ITERATIONS
    return BlockSolveResult(x=x, restarts=k, residuals=rel, residual=torch.max(rel),
                            status=int(status), host_syncs=syncs)
