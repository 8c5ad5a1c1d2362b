"""Block CG (O'Leary 1980): s right-hand sides, one block-Krylov iteration,
in eager PyTorch.

Counterpart of ``gmres_tpu/solvers/block_cg.py``, with its arithmetic: the
search block P is re-whitened by clamped SVQB every iteration (block
GMRES's, ``ops/blas.py:_orthonormalize_block``), so a rank-deficient
block (duplicate or zero right-hand sides) does not break down; each
iteration takes the two (s, s) Grams PᵀAP and PᵀR and two jittered Cholesky solves
(``torch.linalg.cholesky_ex``/``torch.cholesky_solve``, which do not read
the factorisation's status back from the device; a failed factor is NaN,
as JAX's ``cho_factor`` gives). Convergence needs every right-hand side
under the absolute ``tol``, and the returned residuals are the certified
true ‖bᵢ − A xᵢ‖.

JAX batches the single-vector operator and preconditioner with
``jax.vmap``; here each block application is ``ops/blas.py:row_apply``
(``torch.func.vmap`` over the s rows: on the card one launch of each
kernel of the operator's, or the preconditioner's, path for all rows).

The solve is a generator of steps (``block_cg_steps``,
``solvers/requests.py``): ``block_cg`` drives it on its own,
``solvers/batched.py`` one a lane, each lane a block of s right-hand sides
(a block application of every lane is one nested vmap, one launch a
kernel for all lanes' rows).

``lax.while_loop`` becomes a Python loop. Host reads
(``BlockCGResult.host_syncs``): the initial residuals, one an iteration
(the convergence and breakdown flags together) and, after a CONVERGED
loop, the certification.
Beyond those, SVQB's two ``eigh`` calls an iteration synchronise with the
card (torch's eigensolver reads its status), a known difference from JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from gmres_tpu_torch.ops.blas import (
    _orthonormalize_block,
    as_plain,
    replicate_like,
)
from gmres_tpu_torch.solvers.gmres import _as_operator
from gmres_tpu_torch.solvers.requests import Apply, Read, rows, run
from gmres_tpu_torch.types import Preconditioner, SolverStatus, _fields_numpy


@dataclasses.dataclass(frozen=True)
class BlockCGResult:
    """Result of :func:`block_cg`.

    Attributes (the fields of ``gmres_tpu.BlockCGResult``):
      x: (s, *shape) stacked solutions.
      iterations: block iterations performed.
      residuals: (s,) certified true ‖bᵢ − A xᵢ‖ per right-hand side
        (absolute).
      residual: max over ``residuals``, a 0-d tensor.
      status: SolverStatus code (CONVERGED iff every RHS converged).

    Beyond the JAX fields:
      host_syncs: device→host reads the solve made to decide its loop.
    """

    x: torch.Tensor
    iterations: int
    residuals: torch.Tensor
    residual: torch.Tensor
    status: int
    host_syncs: int = 0

    @property
    def converged(self) -> bool:
        return self.status == SolverStatus.CONVERGED

    def to_numpy(self) -> dict:
        """The JAX result fields as numpy values."""
        return _fields_numpy(self, ("x", "iterations", "residuals", "residual",
                                    "status"))


def block_cg(
    A,
    B: torch.Tensor,
    *,
    tol: float = 1e-9,
    max_iterations: int = 10_000,
    M: Optional[Preconditioner] = None,
    X0: Optional[torch.Tensor] = None,
) -> BlockCGResult:
    """Solve A xᵢ = bᵢ (A SPD) for the s stacked right-hand sides B[i] (the
    arguments of ``gmres_tpu.block_cg``).

      A: single-vector SPD operator (applied row by row) or dense (n, n)
        matrix.
      B: (s, *shape) stacked right-hand sides (duplicates and zeros are
        fine: the clamped whitening absorbs rank deficiency).
      tol: per-RHS absolute ‖bᵢ − A xᵢ‖₂ target.
      max_iterations: block-iteration cap.
      M: optional SPD preconditioner (single-vector callable).
      X0: optional (s, *shape) initial guesses.
    """
    return run(block_cg_steps(A, B, tol=tol, max_iterations=max_iterations, M=M, X0=X0))


def block_cg_steps(A, B, *, tol=1e-9, max_iterations=10_000, M=None, X0=None):
    """``block_cg``'s solve as steps (``solvers/requests.py``), returning its
    BlockCGResult: each block application one request (``requests.rows``;
    in a batched solve one nested vmap, each lane a block)."""
    op1 = _as_operator(A, B.device)
    s = B.shape[0]
    dtype = B.dtype
    eps = float(torch.finfo(dtype).eps)
    tiny = torch.finfo(dtype).tiny
    eye = torch.eye(s, dtype=dtype, device=B.device)

    def a_block(v):
        return (yield Apply(rows(op1), v))

    def m_block(v):
        return (yield Apply(rows(M), v)) if M is not None else v

    def bdot(u, v):
        return as_plain(u.reshape(s, -1) @ v.reshape(s, -1).T)        # (s, s)

    def comb(c, blk):
        return torch.tensordot(replicate_like(c, blk), blk, dims=([0], [0]))

    def rownorms(blk):
        return torch.sqrt(as_plain(torch.sum(blk.reshape(s, -1) ** 2, dim=1)))

    def solve_spd(g, rhs):
        # Clamped SVQB keeps g ≈ I; the jitter guards the residue of a
        # fully dependent direction.
        gj = g + (eps * torch.max(torch.abs(torch.diagonal(g))) + tiny) * eye
        chol, info = torch.linalg.cholesky_ex(0.5 * (gj + gj.T))
        chol = torch.where(info == 0, chol, torch.full_like(chol, float("nan")))
        return torch.cholesky_solve(rhs, chol)

    x = torch.zeros_like(B) if X0 is None else X0
    r = B - (yield from a_block(x)) if X0 is not None else B
    p, _ = _orthonormalize_block((yield from m_block(r)), eps)
    status = int(SolverStatus.CONVERGED if (yield Read(torch.max(rownorms(r)) < tol))
                 else SolverStatus.MAX_ITERATIONS)
    syncs = 1
    i = 0
    while i < max_iterations and status == SolverStatus.MAX_ITERATIONS:
        q = yield from a_block(p)
        g = bdot(p, q)                      # PᵀAP (s, s)
        alpha = solve_spd(g, bdot(p, r))    # Galerkin: PᵀR_new = 0
        x = x + comb(alpha, p)
        r = r - comb(alpha, q)
        zn = yield from m_block(r)
        beta = -solve_spd(g, bdot(q, zn))   # A-orthogonalise against P
        p, _ = _orthonormalize_block(zn + comb(beta, p), eps)
        resn = rownorms(r)
        converged, finite = yield Read(torch.stack(
            [torch.max(resn) < tol, torch.all(torch.isfinite(resn))]))
        syncs += 1
        if converged:
            status = int(SolverStatus.CONVERGED)
        if not finite:
            status = int(SolverStatus.BREAKDOWN)
        i += 1

    # Certified per-RHS true residuals.
    res_true = rownorms(B - (yield from a_block(x)))
    residual = torch.max(res_true)
    if status == SolverStatus.CONVERGED:
        syncs += 1
        if (yield Read(residual >= tol)):
            status = int(SolverStatus.BREAKDOWN)
    return BlockCGResult(x=x, iterations=i, residuals=res_true, residual=residual,
                         status=status, host_syncs=syncs)
