"""Dominant nonsymmetric eigenpairs by real orthogonal subspace iteration
(Stewart's SRRIT).

Counterpart of ``gmres_tpu/solvers/subspace_eigs.py``, with its phases:

  1. device: Z ← A(Q) over the block, Q ← qr(Z), ``iters`` times; then
     H = Qᵀ A Q, a (p, p) matrix read to the host;
  2. host: ``numpy.linalg.eig(H)`` → (λ, W), sorted by modulus;
  3. device: the Ritz vectors and residuals in split real/imaginary form
     (two real block applications).

JAX's ``jax.vmap`` of A over the block is a loop over its p rows here (on
the card, p applications of A's kernels). The start block cannot be JAX's
(``PRNGKey(11)`` has no torch counterpart): it comes from one seam,
``_start_block``. Convergence is linear at |λ_p|/|λ_{p+1}|: estimation
grade on clustered dominant moduli (JAX's contract).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from gmres_tpu_torch.ops.blas import (
    as_plain,
    complex_from,
    gram,
    is_dtensor,
    row_apply,
    row_combine,
    row_op,
    shard_rows_like,
)
from gmres_tpu_torch.types import EigResult, SolverStatus


def _start_block(n: int, p: int, dtype: torch.dtype, device) -> torch.Tensor:
    """The (n, p) standard-normal start block before the probe is added: a
    CPU torch.Generator seeded 11 (JAX draws from PRNGKey(11)), drawn in
    float64 so every device and dtype starts from the same numbers."""
    gen = torch.Generator(device="cpu").manual_seed(11)
    return torch.randn((n, p), generator=gen, dtype=torch.float64).to(device, dtype)


def _orthonormal_rows(rows: torch.Tensor) -> torch.Tensor:
    """Orthonormal rows spanning those of the (p, *shape) block: the Q of
    LAPACK's QR of the (n, p) column block on a plain block; on a sharded
    one, CholQR2 (two passes of R = chol(Gram), Q = rows·R⁻¹, each Gram one
    all-reduce of ``gram``), which keeps every rank on its own rows where a
    QR would gather the tall block. The two differ by column signs and
    rounding, which do not move the Ritz values."""
    p = rows.shape[0]
    if not is_dtensor(rows):
        q, _ = torch.linalg.qr(rows.reshape(p, -1).T)
        return q.T.reshape(rows.shape)
    for _ in range(2):
        r = torch.linalg.cholesky(gram(rows, rows), upper=True)
        eye = torch.eye(p, dtype=r.dtype, device=r.device)
        rows = row_combine(torch.linalg.solve_triangular(r, eye, upper=True), rows)
    return rows


def subspace_eigs(
    A: Callable,
    probe: torch.Tensor,
    *,
    nev: int = 4,
    guard: int = 4,
    iters: int = 200,
    tol: float = 0.0,
    which: str = "LM",
) -> EigResult:
    """The nev dominant eigenpairs of a real operator (the arguments of
    ``gmres_tpu.subspace_eigs``): p = nev + guard basis columns, ``iters``
    block iterations. probe fixes the shape and dtype and is added to the
    start block's first column.

    Returns an EigResult with complex eigenvalues and eigenvectors (tensors
    on the probe's device), the true per-pair ‖A x − λ x‖₂ with unit x, and
    status CONVERGED when every residual is below tol (or tol is 0).
    host_syncs: the read of H and the one of the residuals.
    """
    if which != "LM":
        raise ValueError(
            "subspace iteration converges to the DOMINANT subspace; "
            "only which='LM' is meaningful (shift-invert via "
            "arnoldi_eigs covers interior targets on complex-capable "
            "backends)")
    p = nev + guard
    shape = tuple(probe.shape)
    n = probe.numel()
    rdtype, dev = probe.dtype, probe.device

    def a_block(rows):
        """A on each of the rows (p, *shape) → (p, *shape), made contiguous
        first (a kernel takes no strided view)."""
        return row_apply(A, rows.contiguous())

    # The block is kept as p rows shaped like the probe ([Shard(1)] for a
    # row-sharded probe, each rank holding its rows of the same draws).
    rows = shard_rows_like(_start_block(n, p, rdtype, dev).T.reshape((p,) + shape),
                           probe)
    rows[0] += probe
    q = _orthonormal_rows(rows)
    for _ in range(iters):
        q = _orthonormal_rows(a_block(q))
    aq = a_block(q)
    h_np = gram(q, aq).detach().to("cpu", torch.float64).numpy()
    lam, w = np.linalg.eig(h_np)
    order = np.argsort(-np.abs(lam))[:nev]
    lam = lam[order]
    w = w[:, order]
    w = w / np.linalg.norm(w, axis=0, keepdims=True)

    def on_dev(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=rdtype, device=dev)

    wr, wi, lr, li = on_dev(w.real), on_dev(w.imag), on_dev(lam.real), on_dev(lam.imag)
    xr = row_combine(wr, q)
    xi = row_combine(wi, q)
    axr, axi = a_block(xr), a_block(xi)
    rr = axr - (row_op(torch.mul, xr, lr) - row_op(torch.mul, xi, li))
    ri = axi - (row_op(torch.mul, xi, lr) + row_op(torch.mul, xr, li))
    axes = tuple(range(1, len(shape) + 1))
    res = torch.sqrt(as_plain(torch.sum(rr * rr + ri * ri, dim=axes)))
    res_np = res.detach().cpu().numpy()
    if not np.all(np.isfinite(res_np)):
        status = SolverStatus.BREAKDOWN
    elif tol <= 0 or np.max(res_np) < tol:
        status = SolverStatus.CONVERGED
    else:
        status = SolverStatus.MAX_ITERATIONS
    return EigResult(
        eigenvalues=torch.as_tensor(lam, dtype=rdtype.to_complex(), device=dev),
        x=complex_from(xr, xi),
        iterations=iters, residuals=res, status=int(status), host_syncs=2)
