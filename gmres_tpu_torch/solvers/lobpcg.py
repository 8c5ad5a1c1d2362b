"""LOBPCG: the preconditioned block eigensolver for SPD (or Hermitian
positive definite) operators and pencils (Knyazev 2001).

Counterpart of ``gmres_tpu/solvers/lobpcg.py``, with its algorithm: the
[X | W | P] basis orthonormalised jointly by SVQB twice in the B-inner
product (B·q kept by recombination), degenerate rows (W rows of converged
pairs, the zero first P) replaced by fallback directions before the
orthonormalisation, P the implicit difference X⁺ − X(X·X⁺), and the
Rayleigh–Ritz on the 3k×3k projected matrix.

JAX's ``while_loop`` is a Python loop over steps (``lobpcg_steps``,
``solvers/requests.py``) and its ``jax.vmap`` over the block one block
application (``requests.rows``): an iteration applies A to 3k rows, M to k
and B (when given) to 3k. The small eigenproblems (each SVQB pass's Gram
and the Rayleigh–Ritz matrix) are solved by ``eigh`` on float64
(complex128) CPU copies, each one read of the device
(``EigResult.host_syncs``); the loop's decision is one more read an
iteration. In a batched solve (``solvers/batched.py``) each lane is a
block: the lanes' block applications are one nested vmap, and their reads
one read.

Random rows cannot be JAX's (``PRNGKey`` draws have no torch counterpart):
the guard rows and the fallback directions come from two seams,
``_guard_rows`` and ``_fallback_rows``, seeded torch Generators on the
block's device.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from gmres_tpu_torch.ops.blas import (
    as_plain,
    gram,
    on_local,
    place_like,
    row_combine,
    row_op,
    shard_rows_like,
)
from gmres_tpu_torch.solvers.requests import Apply, read_host, rows, run
from gmres_tpu_torch.types import EigResult, SolverStatus


def _guard_rows(guard: int, shape, dtype, device) -> torch.Tensor:
    """The (guard, *shape) standard-normal guard rows appended to X0 (JAX:
    ``fold_in(PRNGKey(1), guard)``)."""
    gen = torch.Generator(device=device).manual_seed(1_000 + guard)
    return torch.randn((guard,) + tuple(shape), generator=gen, dtype=dtype, device=device)


def _fallback_rows(i: int, salt: int, shape, dtype, device) -> torch.Tensor:
    """The standard-normal block that replaces degenerate rows at iteration
    i (−1 for the setup), salt 0 for X0, 1 for W, 2 for P (JAX:
    ``fold_in(fold_in(PRNGKey(0), i), salt)``): fresh each iteration, drawn
    on the device so no row is read back."""
    gen = torch.Generator(device=device).manual_seed(3 * (i + 1) + salt)
    return torch.randn(tuple(shape), generator=gen, dtype=dtype, device=device)


def _rows_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(p, *shape) × (q, *shape) → (p, q) Gram block conj(a)·bᵀ, a plain
    tensor (one all-reduce on a sharded block)."""
    return gram(a.conj(), b)


def _row_norms(v: torch.Tensor) -> torch.Tensor:
    """The (k,) Euclidean norms of the rows of a (k, *shape) block, plain."""
    return torch.sqrt(as_plain(torch.sum(v.reshape(v.shape[0], -1).abs() ** 2, dim=1)))


def _svqb_b_steps(w, bw, eps, same):
    """One SVQB pass in the B-inner product, as steps: the whitening of the
    Gram conj(w)·(B w), read once and formed on the host, applied to w and
    to B w (B·q by recombination). ``same``: B is the identity, so B q is
    q."""
    g = yield from read_host(_rows_dot(w, bw))
    d = torch.sqrt(torch.clamp(torch.diagonal(g).real, min=0.0))
    dinv = torch.where(d > 0, 1.0 / torch.where(d > 0, d, torch.ones_like(d)),
                       torch.zeros_like(d))
    gs = g * dinv[:, None] * dinv[None, :]
    lam, u = torch.linalg.eigh(0.5 * (gs + gs.conj().T))
    lmax = torch.clamp(lam[-1], min=eps)
    lam_c = torch.clamp(lam, min=float(eps * lmax))
    smat = ((dinv[:, None] * u) / torch.sqrt(lam_c)[None, :]).to(w.device, w.dtype)
    q = row_combine(smat, w)
    return q, (q if same else row_combine(smat, bw))


def lobpcg(
    A: Callable[[torch.Tensor], torch.Tensor],
    X0: torch.Tensor,
    *,
    tol: float = 1e-6,
    rtol: float = 0.0,
    max_iterations: int = 200,
    M: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    B: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    guard: int = 0,
) -> EigResult:
    """The k smallest eigenpairs of the SPD (real) or HPD (complex) operator
    A, or of the pencil A x = λ B x with B SPD (the arguments of
    ``gmres_tpu.lobpcg``).

      A: single-vector operator, applied row by row.
      X0: (k, *shape) start block; degenerate rows (zeros, duplicates) are
        replaced by fallback directions.
      tol, rtol: every returned pair must reach
        ‖A xᵢ − λᵢ B xᵢ‖₂ < max(tol, rtol·|λᵢ|) with B-unit xᵢ.
      max_iterations: iteration cap.
      M: SPD preconditioner ≈ A⁻¹ (e.g. a multigrid cycle).
      B: SPD mass operator (None: the standard problem).
      guard: extra trailing pairs computed but not returned.

    Returns an EigResult: eigenvalues (k,) ascending, x (k, *shape)
    B-orthonormal rows, iterations, residuals (k,), status (BREAKDOWN on a
    non-finite residual), host_syncs.
    """
    return run(lobpcg_steps(A, X0, tol=tol, rtol=rtol, max_iterations=max_iterations,
                            M=M, B=B, guard=guard))


def lobpcg_steps(A, X0, *, tol=1e-6, rtol=0.0, max_iterations=200, M=None, B=None,
                 guard=0):
    """``lobpcg`` as steps (``solvers/requests.py``): each block
    application of A, M and B one request on ``requests.rows`` (in a
    batched solve one nested vmap, a launch a kernel for the lanes' rows),
    and each SVQB Gram, Rayleigh–Ritz matrix and decision one read, its
    eigh on the lane's own CPU copy."""
    k_out = X0.shape[0]
    dtype, dev = X0.dtype, X0.device
    shape = tuple(X0.shape[1:])
    if guard:
        X0 = torch.cat([X0, shard_rows_like(_guard_rows(guard, shape, dtype, dev), X0[0])],
                       dim=0)
    k = X0.shape[0]
    eps = float(torch.finfo(dtype).eps)
    rdtype = dtype.to_real() if dtype.is_complex else dtype
    bc = (-1,) + (1,) * len(shape)
    syncs = 0

    def a_block(s):
        return (yield Apply(rows(A), s))

    def m_block(r):
        return (yield Apply(rows(M), r)) if M is not None else r

    def b_block(s):
        return (yield Apply(rows(B), s)) if B is not None else s

    def fill_degenerate(v, i, salt):
        """Rows with norm at most √eps times the block's largest are replaced
        by the fallback block's rows (all of them when the block is zero)."""
        norms = _row_norms(v)
        keep = norms > (eps ** 0.5) * torch.max(norms)
        # The same draws on a sharded block, each rank keeping its rows.
        noise = place_like(_fallback_rows(i, salt, v.shape, dtype, dev), v)
        return on_local(lambda t, z: torch.where(keep.reshape(bc), t, z), v, noise)

    def rayleigh_ritz(s):
        """Jointly B-orthonormalise the rows, then Ritz-extract the k
        smallest pairs: (lam, x, r, resnorm)."""
        nonlocal syncs
        q, bq = yield from _svqb_b_steps(s, (yield from b_block(s)), eps, B is None)
        q, bq = yield from _svqb_b_steps(q, bq, eps, B is None)
        aq = yield from a_block(q)
        h = yield from read_host(_rows_dot(q, aq))
        syncs += 3
        lam_all, c = torch.linalg.eigh(0.5 * (h + h.conj().T))
        ck = c[:, :k].to(dev, dtype)
        x, ax = row_combine(ck, q), row_combine(ck, aq)
        bx = x if B is None else row_combine(ck, bq)
        lam = lam_all[:k].to(dev, rdtype)
        r = ax - row_op(torch.mul, bx, lam)
        resnorm = _row_norms(r)
        # A Ritz vector that lost its unit B-norm must not pass on its small
        # residual: a large finite sentinel (a transient rank deficiency is
        # repaired by the next iteration; a NaN is a breakdown).
        big = torch.finfo(rdtype).max ** 0.5
        xnorm = torch.sqrt(torch.abs(as_plain(torch.sum(
            x.reshape(k, -1).conj() * bx.reshape(k, -1), dim=1))))
        resnorm = torch.where(torch.abs(xnorm - 1.0) < 0.5, resnorm,
                              torch.full_like(resnorm, big))
        return lam, x, r, resnorm

    def decide(lam, res, status, breakdown=True):
        """One read: the convergence gate on the returned pairs, then (in the
        loop, as in JAX) the breakdown test on all."""
        nonlocal syncs
        lam_h, res_h = (yield from read_host(torch.stack([lam, res]))).unbind(0)
        syncs += 1
        thresh = torch.clamp(rtol * lam_h[:k_out].abs(), min=tol)
        if bool((res_h[:k_out] < thresh).all()):
            status = SolverStatus.CONVERGED
        if breakdown and not bool(torch.isfinite(res_h).all()):
            status = SolverStatus.BREAKDOWN
        return status

    lam, x, r, resnorm = yield from rayleigh_ritz(fill_degenerate(X0, -1, 0))
    status = yield from decide(lam, resnorm, SolverStatus.MAX_ITERATIONS, breakdown=False)
    p = torch.zeros_like(x)
    i = 0
    while i < max_iterations and status == SolverStatus.MAX_ITERATIONS:
        w = fill_degenerate((yield from m_block(r)), i, 1)
        p_f = fill_degenerate(p, i, 2)
        lam_n, x_n, r, resnorm = yield from rayleigh_ritz(torch.cat([x, w, p_f], dim=0))
        p = x_n - row_combine(_rows_dot(x, x_n), x)
        x, lam = x_n, lam_n
        status = yield from decide(lam, resnorm, status)
        i += 1
    return EigResult(eigenvalues=lam[:k_out], x=x[:k_out], iterations=i,
                     residuals=resnorm[:k_out], status=int(status), host_syncs=syncs)
