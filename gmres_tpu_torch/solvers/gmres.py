"""Restarted GMRES(m) with Householder (Walker '84) and MGS-with-
reorthogonalisation (MGSR) Arnoldi, in eager PyTorch.

Counterpart of ``gmres_tpu/solvers/gmres.py``, with the same variants,
options and arithmetic:

* Fixed-size basis buffers (m+1, *shape), zero-initialised; reflector
  products in compact-WY form (ops/householder.py); Givens updates on an
  accumulated rotation matrix (ops/givens.py); masked back-substitution
  (ops/tri.py). The small-matrix state (H, g, Ω, y) is kept in the outer
  dtype.
* MGSR orthogonalises twice per column, by classical ("cgs2": one basis
  contraction and one rank update per pass) or modified ("mgs2": one dot
  per basis row, the JAX ``lax.scan`` as a Python loop) Gram-Schmidt.
  Both passes touch only the rows written so far: the JAX buffers' zero
  rows contribute exact zeros, so skipping them changes no value.
* Mixed precision (``inner_dtype``): Arnoldi cycles in the work dtype,
  residuals and Hessenberg state in the outer dtype, convergence certified
  at restart boundaries (GMRES-IR).
* Type promotion: in JAX with x64, a float32 array combined with a 0-d
  float64 array gives float64; in PyTorch a 0-d tensor does not promote.
  Every value whose dtype JAX fixes by promotion is cast explicitly here
  (``h_val``, ``hcol``, the β-normalised vectors before their work-dtype
  casts, the x update).

``lax.while_loop`` becomes a Python loop: each inner iteration that tests
convergence reads one boolean from the device, and each restart reads one
status code (``GmresResult.host_syncs`` counts them). The loop indices are
Python ints, so indexing the buffers reads nothing back. The loops are
generators of steps (``gmres_steps``): each application of A or M and each
read is a request to its runner (``solvers/requests.py``). ``gmres`` runs
them on its own; ``solvers/batched.py`` drives one per lane of a batched
solve.

Row-sharded vectors: both variants run on a ``[Shard(0)]`` DTensor b
(``parallel/mesh.py``). The bases are then sharded along the grid rows
(``ops/blas.py:rows_like``), the reductions of ``ops/blas.py`` all-reduce
over the mesh and return plain tensors, so the small state stays plain and
identical on every rank. The Householder variant reads and writes single
flat components of the vectors (the Hessenberg column is the head of the
reflected vector, the reflector's leading entry is shifted), which JAX
reaches through GSPMD; here ``ops/flat.py`` writes them on the rank that
owns the index and reads them with one all-reduce of a vector that is
zero elsewhere.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from gmres_tpu_torch.ops import householder as wy
from gmres_tpu_torch.ops.blas import (
    gram,
    row_combine,
    row_contract,
    rows_like,
    tree_vdot,
)
from gmres_tpu_torch.ops.flat import (
    flat_add,
    flat_embed,
    flat_get,
    flat_head,
    flat_tail_sq,
    mask_ge,
)
from gmres_tpu_torch.ops.givens import givens_init, givens_step
from gmres_tpu_torch.ops.tri import masked_back_substitution
from gmres_tpu_torch.solvers.requests import Apply, Read, run
from gmres_tpu_torch.types import (
    GmresResult,
    LinearOperator,
    Preconditioner,
    SolverStatus,
)


def _as_operator(A, device=None) -> LinearOperator:
    """Accept a dense matrix (tensor or numpy array, moved to ``device``)
    or a callable operator."""
    if isinstance(A, np.ndarray):
        A = torch.as_tensor(A)
    if isinstance(A, torch.Tensor):
        mat = A.to(device) if device is not None else A
        return lambda v: (mat.to(v.dtype) @ v if v.dtype != mat.dtype
                          else mat @ v)
    if not callable(A):
        raise TypeError(
            f"A must be a dense matrix or a callable operator, got {type(A)}"
        )
    return A


def _fortran_sign(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Fortran sign(a, b) = |a|·sign(b), with sign(0) = + (also for −0.0,
    which is why this is not ``copysign``)."""
    return torch.where(b >= 0, a.abs(), -a.abs())


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(tree_vdot(v, v).real)


def _nonzero_or_one(v: torch.Tensor) -> torch.Tensor:
    return torch.where(v > 0, v, torch.ones_like(v))


def _v_err_householder(gram: torch.Tensor, n_out: int, dtype) -> torch.Tensor:
    """v_err(i) = Σ_{j<i} 2(Vi·Vj)², returned (m+1,) with the reference's
    indexing (entry r ↔ Fortran v_err(r+1))."""
    mm = gram.shape[0]
    idx = torch.arange(mm, device=gram.device)
    off = torch.where(idx[None, :] < idx[:, None], gram ** 2,
                      torch.zeros_like(gram))
    v = 2.0 * torch.sum(off, dim=1)
    v = torch.where(idx < n_out, v, torch.zeros_like(v))
    return torch.cat([v, torch.zeros(1, dtype=v.dtype, device=v.device)]).to(dtype)


def _v_err_mgsr(gram: torch.Tensor, n_out: int, rdtype) -> torch.Tensor:
    """Cumulative orthogonality chain of the MGSR reference:
    v_err(j+1)² = v_err(j)² + Σ_{i≤j} 2|Vi·V_{j+1}|² + |V_{j+1}·V_{j+1} − 1|²."""
    mp1 = gram.shape[0]
    idx = torch.arange(mp1, device=gram.device)
    sq = gram.abs() ** 2
    off = torch.where(idx[None, :] < idx[:, None], sq, torch.zeros_like(sq))
    a = 2.0 * torch.sum(off, dim=1) + (torch.diagonal(gram) - 1.0).abs() ** 2
    active = (idx >= 1) & (idx <= n_out)
    a = torch.where(active, a, torch.zeros_like(a))
    return torch.sqrt(torch.cumsum(a, 0)).to(rdtype) * active.to(rdtype)


def _cgs_pass(v_basis: torch.Tensor, w: torch.Tensor):
    """Classical Gram-Schmidt pass over the basis rows given: h = V̄·w,
    w ← w − Vᵀh (one all-reduce on a mesh)."""
    h = row_contract(v_basis, w, conj=True)
    return h, w - row_combine(h, v_basis)


def _mgs_pass(v_basis: torch.Tensor, w: torch.Tensor):
    """Modified Gram-Schmidt pass: sequential over the basis rows given,
    one dot (one all-reduce on a mesh) per row."""
    hs = []
    for i in range(v_basis.shape[0]):
        v_row = v_basis[i]
        h = tree_vdot(v_row, w)  # ⟨v, w⟩: conjugate-linear in v
        w = w - h * v_row
        hs.append(h)
    return torch.stack(hs), w


def _inner_floor(beta, beta0, rel_prev, tol, inner_gain, certify_true,
                 mixed, tiny):
    """The inner convergence floor of one cycle (shared by both variants).
    Certification is in another norm than the inner estimate: stop the
    cycle when the work dtype can no longer improve it, or near the target
    projected through the preconditioned/true norm ratio measured at the
    restart boundary. In mixed mode stop at ~ε_work of the cycle-start
    residual."""
    if certify_true:
        return (beta / beta0) * torch.clamp(
            0.1 * tol / torch.clamp(rel_prev, min=tiny), min=inner_gain
        )
    if mixed:
        return torch.clamp((beta / beta0) * inner_gain, min=tol)
    return tol


# ---------------------------------------------------------------------------
# Restarted driver: each restart starts from the preconditioned true
# residual (outer dtype), runs one Arnoldi cycle in the work dtype, updates
# x in the outer dtype and decides convergence — from the inner Givens
# estimate in pure mode, from the true residual in mixed/certified mode.
# ---------------------------------------------------------------------------


def _restarted_steps(
    cycle: Callable,
    A: LinearOperator,
    b: torch.Tensor,
    x0: torch.Tensor,
    m: int,
    tol: float,
    max_restarts: int,
    M: Optional[Preconditioner],
    mixed: bool,
    breakdown_check: bool,
    certify_true: bool,
    work_dtype,
):
    """The restart loop as steps (``solvers/requests.py``); ``cycle``
    is a generator function of steps too."""
    dtype = b.dtype
    rdtype = dtype.to_real()  # norms and the residual history
    beta0 = _norm(b)
    tiny = torch.finfo(dtype).tiny

    def true_residual(x):
        r = b - (yield Apply(A, x))
        if M is None:
            w = r
        elif mixed:
            # Apply M at work precision on the residual normalised in the
            # outer dtype (scale invariance: M is linear).
            scale = _nonzero_or_one(_norm(r))
            w = (yield Apply(M, (r / scale).to(work_dtype))).to(dtype) * scale
        else:
            w = yield Apply(M, r)
        beta_w = _norm(w)
        if certify_true:
            rel = _norm(r) / torch.clamp(beta0, min=tiny)
        else:
            rel = beta_w / torch.clamp(beta0, min=tiny)
        return w, beta_w, rel

    w, beta, rel_init = yield from true_residual(x0)
    syncs = 1
    converged = yield Read((beta0 == 0) | (rel_init < tol))
    breakdown = False
    x, k, n_out, rel_prev = x0, 0, 0, rel_init
    ferr = torch.zeros((m,), dtype=rdtype, device=b.device)
    basis = None
    while k < max_restarts and not converged and not breakdown:
        x_new, n_out, ferr, h_val, basis, inner_syncs = yield from cycle(
            x, w, beta, beta0, rel_prev
        )
        syncs += inner_syncs
        w_new, beta_new, rel_new = yield from true_residual(x_new)
        last = max(n_out - 1, 0)
        if mixed or certify_true:
            conv = rel_new < tol
        else:
            conv = ferr[last] < tol
        if breakdown_check:
            bd = (h_val < tol) & ~conv
        else:
            bd = torch.zeros((), dtype=torch.bool, device=b.device)
        # NaN/Inf escaping the operator or preconditioner ends the solve.
        bd = bd | ~torch.isfinite(beta_new)
        if mixed or certify_true:
            # Fold the certified residual into the last active history slot
            # (ferr belongs to this cycle, so in place is safe).
            ferr[last] = rel_new
        code = yield Read(torch.where(conv, 0, torch.where(bd, 2, 1)))
        syncs += 1
        converged, breakdown = code == 0, code == 2
        x, k, w, beta, rel_prev = x_new, k + 1, w_new, beta_new, rel_new

    if converged:
        status = SolverStatus.CONVERGED
    elif breakdown:
        status = SolverStatus.BREAKDOWN
    else:
        status = SolverStatus.MAX_ITERATIONS
    if k > 0:
        residual = ferr[max(n_out - 1, 0)].clone()
    elif mixed or certify_true:
        residual = rel_init
    else:
        residual = beta / torch.clamp(beta0, min=tiny)
    return x, k, n_out, ferr, basis, int(status), residual, syncs


# ---------------------------------------------------------------------------
# Householder (compact-WY) variant.
# ---------------------------------------------------------------------------


def _householder_steps(
    A: LinearOperator,
    b: torch.Tensor,
    x0: torch.Tensor,
    m: int,
    tol: float,
    max_restarts: int,
    M: Optional[Preconditioner],
    check_inner: bool,
    compute_v_err: bool,
    breakdown_check: bool,
    work_dtype,
    certify_true: bool,
) -> GmresResult:
    dtype = b.dtype
    shape = b.shape
    dev = b.device
    mixed = work_dtype != dtype
    inner_gain = float(torch.finfo(work_dtype).eps) * 10.0
    tiny = torch.finfo(dtype).tiny

    def cycle(x, w, beta, beta0, rel_prev):
        # Initial reflector from w: g(1) = −sign(β, w₁); w₁ += sign(β, w₁);
        # P₁ = w/‖w‖, normalised by β in the outer dtype before the
        # work-dtype cast (scale invariance).
        s = _fortran_sign(beta, flat_get(w, 0))
        g0 = torch.zeros((m + 1,), dtype=dtype, device=dev)
        g0[0] = -s
        bsafe = _nonzero_or_one(beta)
        u = (flat_add(w, 0, s) / bsafe).to(work_dtype)
        p_basis = rows_like(m + 1, b, work_dtype)
        p_basis[0] = u / _nonzero_or_one(_norm(u))
        t_mat = torch.zeros((m + 1, m + 1), dtype=work_dtype, device=dev)
        t_mat[0, 0] = 2.0
        giv = givens_init(m, g0)._replace(beta0=beta0)
        hmat = torch.zeros((m + 1, m), dtype=dtype, device=dev)
        ferr = torch.zeros((m,), dtype=dtype, device=dev)
        inner_floor = _inner_floor(beta, beta0, rel_prev, tol, inner_gain,
                                   certify_true, mixed, tiny)

        syncs = 0
        t = 0
        while True:
            v_t = wy.wy_basis_vector(p_basis, t_mat, t)
            z = yield Apply(A, v_t)
            w_t = (yield Apply(M, z)) if M is not None else z
            w_t = wy.wy_apply_transpose(p_basis, t_mat, w_t)

            # Hessenberg column: H[0:t+1, t] = w[0:t+1]; H[t+1, t] from the
            # tail norm with Walker's sign choice.
            whead = flat_head(w_t, m + 1)
            tmp = torch.sqrt(flat_tail_sq(w_t, t + 1))
            h_sub = torch.where(whead[t + 1] > 0, -tmp, tmp)
            h_val = tmp.to(dtype)
            hcol = whead.clone()
            hcol[t + 1:] = 0
            hcol[t + 1] = h_sub
            hcol = hcol.to(dtype)

            # New reflector: zero prefix, subtract H(t+1,t) at t+1,
            # normalise; a zero vector on lucky breakdown contributes
            # nothing in compact-WY algebra.
            u = flat_add(mask_ge(w_t, t + 1), t + 1, -h_sub)
            p_new = u / _nonzero_or_one(_norm(u))
            wy.wy_append(p_basis, t_mat, p_new, t + 1)

            giv, col, g_next = givens_step(giv, hcol, t)
            hmat[:, t] = col
            rel = g_next.abs() / giv.beta0
            ferr[t] = rel
            t += 1
            if t >= m:
                break
            if check_inner or mixed:
                converged = rel < inner_floor
                if breakdown_check:
                    converged = converged | (h_val < tol)
                syncs += 1
                if (yield Read(converged)):
                    break
        n_out = t

        y = masked_back_substitution(hmat, giv.g, n_out)
        # Update direction Q [y; 0], y normalised by β before the
        # work-dtype cast and rescaled in the outer dtype.
        dx = wy.wy_apply(p_basis, t_mat, flat_embed(y / bsafe, b).to(work_dtype))
        x = x + bsafe * dx.to(dtype)
        return x, n_out, ferr, h_val, (p_basis, t_mat), syncs

    x, k, n_out, ferr, basis, status, residual, syncs = yield from _restarted_steps(
        cycle, A, b, x0, m, tol, max_restarts, M, mixed,
        breakdown_check=breakdown_check, certify_true=certify_true,
        work_dtype=work_dtype,
    )

    if compute_v_err and basis is not None:
        v = wy.wy_basis(*basis, m)  # (m, n)
        v_err = _v_err_householder(gram(v, v).to(dtype), n_out, dtype)
    else:
        # No cycle ran (or no audit asked): every entry is inactive.
        v_err = torch.zeros((m + 1,), dtype=dtype, device=dev)

    return GmresResult(
        x=x, iterations=n_out, restarts=k, residual=residual,
        status=status, residual_history=ferr, v_err=v_err, host_syncs=syncs,
    )


# ---------------------------------------------------------------------------
# MGSR variant.
# ---------------------------------------------------------------------------


def _mgsr_steps(
    A: LinearOperator,
    b: torch.Tensor,
    x0: torch.Tensor,
    m: int,
    tol: float,
    max_restarts: int,
    M: Optional[Preconditioner],
    orthogonalization: str,
    check_inner: bool,
    compute_v_err: bool,
    work_dtype,
    certify_true: bool,
) -> GmresResult:
    dtype = b.dtype
    rdtype = dtype.to_real()
    dev = b.device
    mixed = work_dtype != dtype
    ortho = _cgs_pass if orthogonalization == "cgs2" else _mgs_pass
    inner_gain = float(torch.finfo(work_dtype).eps) * 10.0
    tiny = torch.finfo(dtype).tiny

    def cycle(x, w, beta, beta0, rel_prev):
        # β-normalised in the outer dtype before the work-dtype cast.
        bsafe = _nonzero_or_one(beta)
        w_work = (w / bsafe).to(work_dtype)
        # Built from w so that a sharded b gives a basis sharded alike.
        v_basis = torch.stack([w_work] + [torch.zeros_like(w_work)] * m)
        g0 = torch.zeros((m + 1,), dtype=dtype, device=dev)
        g0[0] = beta
        giv = givens_init(m, g0)._replace(beta0=beta0.to(dtype))
        hmat = torch.zeros((m + 1, m), dtype=dtype, device=dev)
        ferr = torch.zeros((m,), dtype=rdtype, device=dev)
        inner_floor = _inner_floor(beta, beta0, rel_prev, tol, inner_gain,
                                   certify_true, mixed, tiny)

        syncs = 0
        t = 0
        while True:
            z = yield Apply(A, v_basis[t])
            w_t = (yield Apply(M, z)) if M is not None else z
            # Two passes with H accumulated (the reference's `do k=1,2`),
            # over the t+1 rows written so far.
            h1, w_t = ortho(v_basis[: t + 1], w_t)
            h2, w_t = ortho(v_basis[: t + 1], w_t)
            h_val = _norm(w_t)
            hcol = torch.zeros((m + 1,), dtype=dtype, device=dev)
            hcol[: t + 1] = (h1 + h2).to(dtype)
            hcol[t + 1] = h_val.to(dtype)
            giv, col, g_next = givens_step(giv, hcol, t)
            hmat[:, t] = col
            rel = g_next.abs() / giv.beta0.abs()
            ferr[t] = rel
            # V(:, t+1) is written unconditionally, as the reference does.
            v_basis[t + 1] = w_t / _nonzero_or_one(h_val).to(work_dtype)
            t += 1
            if t >= m:
                break
            if check_inner or mixed:
                converged = (rel < inner_floor) | (h_val.to(rdtype) < tol)
                syncs += 1
                if (yield Read(converged)):
                    break
        n_out = t

        y = masked_back_substitution(hmat, giv.g, n_out)
        # x += Σ y_r V_r, y normalised by β before the work-dtype cast and
        # rescaled in the outer dtype.
        dx = row_combine((y / bsafe).to(work_dtype), v_basis[:m])
        x = x + bsafe * dx.to(dtype)
        return x, n_out, ferr, h_val.to(rdtype), v_basis, syncs

    x, k, n_out, ferr, v_basis, status, residual, syncs = yield from _restarted_steps(
        cycle, A, b, x0, m, tol, max_restarts, M, mixed,
        breakdown_check=True, certify_true=certify_true,
        work_dtype=work_dtype,
    )

    if compute_v_err and v_basis is not None:
        gram_v = gram(v_basis.conj(), v_basis).to(dtype)  # Hermitian Gram
        v_err = _v_err_mgsr(gram_v, n_out, rdtype)
    else:
        v_err = torch.zeros((m + 1,), dtype=rdtype, device=dev)

    return GmresResult(
        x=x, iterations=n_out, restarts=k, residual=residual,
        status=status, residual_history=ferr, v_err=v_err, host_syncs=syncs,
    )


# ---------------------------------------------------------------------------
# Public entry point.
# ---------------------------------------------------------------------------


def gmres(
    A,
    b: torch.Tensor,
    *,
    restart: int = 30,
    tol: float = 1e-8,
    max_restarts: int = 1000,
    M: Optional[Preconditioner] = None,
    variant: str = "householder",
    orthogonalization: str = "cgs2",
    check_inner: bool = True,
    compute_v_err: bool = True,
    breakdown_check: bool = True,
    inner_dtype=None,
    x0: Optional[torch.Tensor] = None,
    certify: str = "preconditioned",
) -> GmresResult:
    """Solve A x = b with restarted GMRES(restart).

    The arguments are those of ``gmres_tpu.gmres``:
      A: callable operator y = A(x) on tensors shaped like b, or a dense
        (n, n) matrix (tensor or numpy array) for a flat b.
      b: right-hand side tensor; its device is the device of the solve. A
        row-sharded DTensor (``shard_grid_vector``) runs either variant
        over the mesh.
      restart: Krylov dimension m per cycle (clamped to b.numel() − 1).
      tol: relative-residual tolerance.
      max_restarts: restart cap.
      M: optional left preconditioner z = M(r).
      variant: "householder" (compact-WY Walker '84) or "mgsr".
      orthogonalization: for mgsr, "cgs2" (classical Gram-Schmidt twice)
        or "mgs2" (modified Gram-Schmidt twice).
      check_inner: test convergence every inner iteration (False: only at
        restart boundaries).
      compute_v_err: run the orthogonality audit.
      breakdown_check: exit on lucky breakdown h_val < tol.
      inner_dtype: torch dtype of the Arnoldi cycles; None = b's dtype.
        torch.float32 with a float64 b is the mixed-precision mode.
      x0: initial guess, defaults to zeros.
      certify: "preconditioned" (‖M(b−Ax)‖/β₀, the reference's semantics)
        or "true" (‖b−Ax‖/β₀).
    """
    return run(gmres_steps(
        A, b, restart=restart, tol=tol, max_restarts=max_restarts, M=M,
        variant=variant, orthogonalization=orthogonalization,
        check_inner=check_inner, compute_v_err=compute_v_err,
        breakdown_check=breakdown_check, inner_dtype=inner_dtype, x0=x0,
        certify=certify))


def gmres_steps(A, b, *, restart=30, tol=1e-8, max_restarts=1000, M=None,
                variant="householder", orthogonalization="cgs2", check_inner=True,
                compute_v_err=True, breakdown_check=True, inner_dtype=None,
                x0=None, certify="preconditioned"):
    """``gmres``'s solve as steps (``solvers/requests.py``), returning its
    GmresResult."""
    if certify not in ("preconditioned", "true"):
        raise ValueError(f"unknown certify {certify}")
    certify_true = certify == "true"
    if b.is_complex() and variant == "householder":
        raise ValueError(
            "variant='householder' is real-only (the Walker sign "
            "convention and reflector algebra assume real arithmetic)"
        )
    op = _as_operator(A, b.device)
    if b.numel() == 1:
        # Degenerate 1×1 system: solve directly.
        a_val = yield Apply(op, torch.ones_like(b))
        singular = a_val == 0
        x = torch.where(~singular, b / torch.where(~singular, a_val,
                                                   torch.ones_like(a_val)),
                        torch.zeros_like(b))
        if x0 is not None:
            x = torch.where(~singular, x, x0)
        r = b - (yield Apply(op, x))
        w = (yield Apply(M, r)) if (M is not None and not certify_true) else r
        residual = (_norm(w) / torch.clamp(_norm(b),
                                           min=torch.finfo(b.dtype).tiny))
        status = yield Read(torch.where(
            residual < tol, 0, torch.where(singular.reshape(()), 2, 1)
        ))
        return GmresResult(
            x=x, iterations=1, restarts=1, residual=residual, status=status,
            residual_history=residual.reshape(1).clone(),
            v_err=torch.zeros((2,), dtype=residual.dtype, device=b.device),
            host_syncs=1,
        )
    restart = min(restart, b.numel() - 1)
    if x0 is None:
        x0 = torch.zeros_like(b)
    work_dtype = inner_dtype if inner_dtype is not None else b.dtype
    if variant == "householder":
        return (yield from _householder_steps(
            op, b, x0, restart, tol, max_restarts, M,
            check_inner, compute_v_err, breakdown_check, work_dtype,
            certify_true,
        ))
    if variant == "mgsr":
        if orthogonalization not in ("cgs2", "mgs2"):
            raise ValueError(f"unknown orthogonalization {orthogonalization}")
        return (yield from _mgsr_steps(
            op, b, x0, restart, tol, max_restarts, M, orthogonalization,
            check_inner, compute_v_err, work_dtype, certify_true,
        ))
    raise ValueError(f"unknown variant {variant}")
