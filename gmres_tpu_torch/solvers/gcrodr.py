"""GCRO-DR: Krylov subspace recycling for sequences of linear systems
(Parks, de Sturler, Mackey, Johnson, Maiti, SISC 2006), in eager PyTorch.

Counterpart of ``gmres_tpu/solvers/gcrodr.py``, with its options and
arithmetic. A recycle pair (U, C) with op·U = C, C orthonormal, is carried
between solves: each cycle projects x += U·(Cᵀr), r −= C·(Cᵀr), runs
m = restart − k Arnoldi steps on (I − C·Cᵀ)·op with the coupling
B = Cᵀ·op·V, and solves the least squares by Givens on H̄ alone (y_U =
−B·y_V). The pair is then updated from the harmonic Ritz vectors of the
combined pencil GᵀG z = θ GᵀF z (or of the plain Hessenberg while the
pair is still zero), realified, rebuilt matvec-free and re-orthonormalised
by SVQB. op = M∘A when M is given (left preconditioning); ``inner_dtype``
follows ``gmres``'s iterative-refinement contract, and the returned
``recycle`` is cast back to b's dtype.

The small eigenproblem is host work: each cycle ends with one read of its
small state (the residual estimate, whether C is live, the cross-Grams
C·U and V·U, the Hessenberg and B, together) into a float64 CPU copy, on
which the pencil, its solve, the eigensolve and the realification run;
the combination coefficients go back to the device. ``deflation`` is "eig",
"subspace" or "auto" (= "eig": the card has complex dtypes).

Host reads: one boolean per inner step after the first (the cycle's
convergence test), that one per cycle, one for the initial residual and
one for the exit certification (``RecycledResult.host_syncs``).

The solve is a generator of steps (``gcrodr_steps``, ``solvers/requests.py``):
``gcrodr`` drives it on its own, ``solvers/batched.py`` one a lane (a
recycle block a lane), and ``newton_krylov``'s gcrodr inner yields from it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from gmres_tpu_torch.ops.blas import (
    _orthonormalize_block,
    as_plain,
    row_combine,
    row_contract,
    rows_like,
)
from gmres_tpu_torch.ops.givens import givens_init, givens_step
from gmres_tpu_torch.ops.hessenberg_eig import eig_select, smallest_invariant_subspace
from gmres_tpu_torch.ops.tri import masked_back_substitution, solve_small
from gmres_tpu_torch.solvers.gmres_dr import (
    F64,
    HOST,
    _harmonic_matrix,
    _realify,
    _resolve_deflation,
)
from gmres_tpu_torch.solvers.requests import Apply, Read, rows, run
from gmres_tpu_torch.types import Preconditioner, SolverStatus


@dataclasses.dataclass(frozen=True)
class RecycledResult:
    """GmresResult-shaped result plus the recycle block for the next solve.

    Attributes (the fields of ``gmres_tpu.solvers.gcrodr.RecycledResult``):
      x: solution.
      iterations: inner iterations in the final cycle.
      restarts: cycles performed (the bootstrap cycle included).
      residual: certified relative true residual ‖rhs − op·x‖/β₀ (0-d).
      status: SolverStatus code.
      residual_history: (max_restarts,) per-cycle relative residual,
        padded with the final value.
      recycle: (k, *shape) U block to pass as ``recycle=`` next.

    Beyond the JAX fields:
      host_syncs: device→host reads the solve made to decide its loops.
    """

    x: torch.Tensor
    iterations: int
    restarts: int
    residual: torch.Tensor
    status: int
    residual_history: torch.Tensor
    recycle: torch.Tensor
    host_syncs: int = 0

    @property
    def converged(self) -> bool:
        return self.status == SolverStatus.CONVERGED


def gcrodr(
    A,
    b: torch.Tensor,
    *,
    k: int = 10,
    restart: int = 40,
    tol: float = 1e-8,
    max_restarts: int = 200,
    M: Optional[Preconditioner] = None,
    recycle: Optional[torch.Tensor] = None,
    x0: Optional[torch.Tensor] = None,
    deflation: str = "auto",
    inner_dtype=None,
) -> RecycledResult:
    """Solve A x = b with GCRO-DR(restart, k) (the arguments of
    ``gmres_tpu.gcrodr``).

      A: linear operator callable (a dense matrix is not accepted).
      b: real right-hand side.
      k: recycle-space dimension (k ≥ 1, k + 2 ≤ restart).
      restart: total subspace width per cycle, k recycled directions plus
        m = restart − k Arnoldi vectors.
      tol: relative tolerance on ‖rhs − op·x‖/β₀ (op = M∘A with M).
      M: optional left preconditioner.
      recycle: (k, *shape) U block from a previous RecycledResult; None
        bootstraps with one plain cycle. An all-zero block means "no
        recycle yet": the first cycle runs undeflated and seeds U.
      x0: initial guess (zeros by default).
      deflation: "eig", "subspace" or "auto" (= "eig").
      inner_dtype: torch dtype of the cycle work; with float32 and a
        float64 b every cycle boundary recomputes the true residual in
        float64 and decides convergence on it.
    """
    return run(gcrodr_steps(A, b, k=k, restart=restart, tol=tol,
                            max_restarts=max_restarts, M=M, recycle=recycle, x0=x0,
                            deflation=deflation, inner_dtype=inner_dtype))


def gcrodr_steps(A, b, *, k=10, restart=40, tol=1e-8, max_restarts=200, M=None,
                 recycle=None, x0=None, deflation="auto", inner_dtype=None):
    """``gcrodr``'s solve as steps (``solvers/requests.py``), returning its
    RecycledResult. The cycle's small state comes back by one ``Read`` (in a
    batched solve one host read for every lane at a cycle's end), each
    lane's pencil and eigensolve run on its own float64 copy, and the
    recycle import is one block application (``requests.rows``)."""
    if b.is_complex():
        raise ValueError("gcrodr supports real dtypes only")
    m = restart - k
    if k < 1 or m < 2:
        raise ValueError(
            f"need k >= 1 and restart >= k + 2, got k={k}, restart={restart}")
    deflation = _resolve_deflation(deflation)
    def op(v):
        av = yield Apply(A, v)
        return (yield Apply(M, av)) if M is not None else av

    def op_rows(block):
        av = yield Apply(rows(A), block)
        return (yield Apply(rows(M), av)) if M is not None else av

    dtype = b.dtype
    dev = b.device
    wdtype = inner_dtype if inner_dtype is not None else dtype
    mixed = wdtype != dtype
    eps = float(torch.finfo(wdtype).eps)
    shape = tuple(b.shape)
    baxes = list(range(1, b.dim() + 1))

    def bmatdot(block_a, block_b):
        """(s, t) cross-Gram of two long blocks."""
        return as_plain(torch.tensordot(block_a, block_b, dims=(baxes, baxes)))

    def vnorm(v):
        return torch.sqrt(as_plain(torch.sum(v * v)))

    rhs = (yield Apply(M, b)) if M is not None else b
    beta0 = vnorm(rhs)
    beta0s = torch.where(beta0 > 0, beta0, torch.ones_like(beta0))
    x = torch.zeros_like(b) if x0 is None else x0
    r = rhs - (yield from op(x)) if x0 is not None else rhs

    def deflation_coefs(mat, nvec):
        """On the host: (dim, nvec) real coefficients spanning the
        smallest-|θ| harmonic Ritz space, and whether they are usable."""
        if deflation == "subspace":
            z, ok = smallest_invariant_subspace(mat, nvec)
            return z, bool(ok)
        vals, vecs, ok = eig_select(mat, nvec, which="smallest")
        return _realify(vals, vecs, nvec, eps)[0], bool(ok)

    def renormalize(u_block, au_block):
        """(U, op·U) → (U', C) with op·U' = C orthonormal."""
        c, rmat = _orthonormalize_block(au_block, eps)
        t = solve_small(rmat, torch.eye(rmat.shape[0], dtype=rmat.dtype, device=dev))
        u_new = row_combine(t, u_block)
        good = as_plain(torch.isfinite(u_new).all()) & as_plain(torch.isfinite(c).all())
        return (torch.where(good, u_new, torch.zeros_like(u_new)),
                torch.where(good, c, torch.zeros_like(c)))

    def arnoldi_cycle(r, u_blk, c_blk):
        """m steps of Arnoldi on (I − C·Cᵀ)·op, tracking B = Cᵀ·op·V."""
        r = r.to(wdtype)
        beta = vnorm(r)
        basis = rows_like(m + 1, b, wdtype)
        basis[0] = r / torch.where(beta > 0, beta, torch.ones_like(beta))
        hraw = torch.zeros((m + 1, m), dtype=wdtype, device=dev)
        hrot = torch.zeros((m + 1, m), dtype=wdtype, device=dev)
        bmat = torch.zeros((k, m), dtype=wdtype, device=dev)
        g0 = torch.zeros((m + 1,), dtype=wdtype, device=dev)
        g0[0] = beta
        giv = givens_init(m, g0, beta0=beta0s.to(wdtype))
        syncs = 0
        t = 0
        while True:
            w = yield from op(basis[t])
            bcol = row_contract(c_blk, w)
            w = w - row_combine(bcol, c_blk)
            hs = []
            for _ in range(2):
                # CGS pass with a second C-deflation folded in.
                h = row_contract(basis[: t + 1], w)
                w = w - row_combine(h, basis[: t + 1])
                b2 = row_contract(c_blk, w)
                w = w - row_combine(b2, c_blk)
                hs.append(h)
                bcol = bcol + b2
            hval = vnorm(w)
            hcol = torch.zeros((m + 1,), dtype=wdtype, device=dev)
            hcol[: t + 1] = hs[0] + hs[1]
            hcol[t + 1] = hval
            giv, col, g_next = givens_step(giv, hcol, t)
            hraw[:, t] = hcol
            hrot[:, t] = col
            bmat[:, t] = bcol
            basis[t + 1] = w / torch.where(hval > 0, hval, torch.ones_like(hval))
            rel = g_next.abs() / beta0s.to(wdtype)
            t += 1
            if t >= m:
                break
            syncs += 1
            if not (yield Read(rel >= tol)):
                break
        y = masked_back_substitution(hrot, giv.g, t)
        return basis, hraw, bmat, y, g0 - hraw @ y, t, rel, syncs

    def host_state(rel, u_blk, c_blk, basis, hraw, bmat):
        """One read: the residual, whether C is live, and the small
        matrices of both recycle updates, in a float64 CPU copy."""
        parts = [rel.reshape(1), as_plain(torch.any(c_blk.abs() > 0)).reshape(1),
                 bmatdot(c_blk, u_blk), bmatdot(basis, u_blk), hraw, bmat]
        host = torch.tensor((yield Read(torch.cat([p.to(F64).reshape(-1) for p in parts]))),
                            dtype=F64, device=HOST)
        rel_h, live, cu, vu, hraw_h, bmat_h = torch.split(
            host, [1, 1, k * k, (m + 1) * k, (m + 1) * m, k * m])
        return (float(rel_h), bool(live), cu.reshape(k, k), vu.reshape(m + 1, k),
                hraw_h.reshape(m + 1, m), bmat_h.reshape(k, m))

    def update_recycle(u_blk, c_blk, basis, cu, vu, hraw_h, bmat_h):
        """The harmonic Ritz update from the combined pencil."""
        km = k + m
        gmat = torch.zeros((km + 1, km), dtype=F64)
        gmat[:k, :k] = torch.eye(k, dtype=F64)
        gmat[:k, k:] = bmat_h
        gmat[k:, k:] = hraw_h
        fmat = torch.zeros((km + 1, km), dtype=F64)
        fmat[:k, :k] = cu
        fmat[k:, :k] = vu
        fmat[k:, k:] = torch.eye(m + 1, m, dtype=F64)
        pencil = solve_small(gmat.T @ fmat, gmat.T @ gmat)
        z, okc = deflation_coefs(pencil, k)  # (km, k)
        zd = z.to(dev, wdtype)
        u_new = row_combine(zd, torch.cat([u_blk, basis[:m]], dim=0))
        au_new = row_combine((gmat @ z).to(dev, wdtype), torch.cat([c_blk, basis], dim=0))
        u_new, c_new = renormalize(u_new, au_new)
        good = (okc and bool(torch.isfinite(z).all())) & as_plain(torch.any(u_new.abs() > 0))
        return torch.where(good, u_new, u_blk), torch.where(good, c_new, c_blk)

    def seed_from_hessenberg(basis, hraw_h):
        """Harmonic Ritz vectors of the plain Hessenberg seed (U, C),
        matvec-free: A·(V z) = V_{m+1}·(H̄ z)."""
        z, okc = deflation_coefs(_harmonic_matrix(hraw_h, m), k)  # (m, k)
        u_new = row_combine(z.to(dev, wdtype), basis[:m])
        au_new = row_combine((hraw_h @ z).to(dev, wdtype), basis)
        u_blk, c_blk = renormalize(u_new, au_new)
        if not okc:
            return torch.zeros_like(u_blk), torch.zeros_like(c_blk)
        return u_blk, c_blk

    history = torch.zeros((max_restarts,), dtype=dtype, device=dev)
    syncs = 0
    if recycle is not None:
        if tuple(recycle.shape) != (k,) + shape:
            raise ValueError(
                f"recycle must be (k, *shape) = {(k,) + shape}, got "
                f"{tuple(recycle.shape)}")
        rec_w = recycle.to(dev, wdtype)
        # The one import cost: k applications of op, one a row.
        u_blk, c_blk = renormalize(rec_w, (yield from op_rows(rec_w)))
        cyc = 0
        rel0 = vnorm(r) / beta0s
    else:
        # Bootstrap: one plain cycle with zero recycle blocks, whose
        # harmonic Ritz vectors seed U.
        u0 = rows_like(k, b, wdtype)
        basis, hraw, _, y, resid_coefs, t, rel0, inner = yield from arnoldi_cycle(r, u0, u0)
        syncs += inner
        x = x + row_combine(y, basis[:m])
        if mixed:
            r = rhs - (yield from op(x))
            rel0 = vnorm(r) / beta0s
        else:
            r = row_combine(resid_coefs, basis)
        history[0] = rel0
        rel0, _, _, _, hraw_h, _ = yield from host_state(
            rel0, u0, u0, basis, hraw, torch.zeros((k, m), dtype=wdtype, device=dev))
        u_blk, c_blk = seed_from_hessenberg(basis, hraw_h)
        cyc = 1
    # The bootstrap's residual came back with its host state; an imported
    # recycle block's is read here.
    conv = rel0 < tol if isinstance(rel0, float) else (yield Read(rel0 < tol))
    status = SolverStatus.CONVERGED if conv else SolverStatus.MAX_ITERATIONS
    syncs += 1

    n_out = 0
    while cyc < max_restarts and status == SolverStatus.MAX_ITERATIONS:
        d = row_contract(c_blk, r.to(wdtype))
        x = x + row_combine(d, u_blk)
        r = r - row_combine(d, c_blk)
        basis, hraw, bmat, y, resid_coefs, n_out, rel, inner = yield from arnoldi_cycle(
            r, u_blk, c_blk)
        syncs += inner
        x = x + row_combine(y, basis[:m]) + row_combine(-(bmat @ y), u_blk)
        if mixed:
            r = rhs - (yield from op(x))
            rel = vnorm(r) / beta0s
        else:
            r = row_combine(resid_coefs, basis)
        history[cyc] = rel
        rel_h, live, cu, vu, hraw_h, bmat_h = yield from host_state(rel, u_blk, c_blk, basis,
                                                                    hraw, bmat)
        syncs += 1
        # A live pair updates through the combined pencil; a zero pair (a
        # zero import, or a failed update) seeds from the plain Hessenberg.
        if live:
            u_blk, c_blk = update_recycle(u_blk, c_blk, basis, cu, vu, hraw_h, bmat_h)
        else:
            u_blk, c_blk = seed_from_hessenberg(basis, hraw_h)
        if rel_h < tol:
            status = SolverStatus.CONVERGED
        elif not np.isfinite(rel_h):
            status = SolverStatus.BREAKDOWN
        cyc += 1

    # Exit certification on the true (preconditioned) residual.
    rel_true = vnorm(rhs - (yield from op(x))) / beta0s
    missed = yield Read(rel_true >= tol)
    syncs += 1
    if status == SolverStatus.CONVERGED and missed:
        status = SolverStatus.BREAKDOWN
    history[cyc:] = rel_true
    return RecycledResult(
        x=x, iterations=n_out, restarts=cyc, residual=rel_true, status=int(status),
        residual_history=history, recycle=u_blk.to(dtype), host_syncs=syncs,
    )
