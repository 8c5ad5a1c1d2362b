"""GMRES-DR, GMRES with deflated restarting (Morgan, SIMAX 2002), in eager
PyTorch.

Counterpart of ``gmres_tpu/solvers/gmres_dr.py``, with its options and
arithmetic. GMRES-DR(m, k) carries the k harmonic Ritz vectors of smallest
modulus across each restart, so a cycle minimises over span{y₁, …, y_k,
r, A M⁻¹ r, …}. As in JAX, the dense lead block Q₀ᵀ (the QR of the
deflated lead block) is embedded in the accumulated rotation Ω, so every
Arnoldi column goes through the unchanged ``givens_step`` and |g[t+1]|
stays the running residual; a conjugate harmonic Ritz pair is realified
into Re/Im columns, with k_eff = k + 1 where a pair straddles the k-cut;
an unusable deflation (an early-exit cycle, a non-finite projection, a
failed eigensolve) falls back to an undeflated restart. M is linear and on
the right.

The harmonic Ritz problem is small host work. Each cycle ends with one
read of its small state (the Hessenberg, the coordinate residual and the
convergence flags, together) into a float64 CPU copy, on which the
eigensolve (``torch.linalg.eig``), the realification, the QRs and the
projections run; the basis transform and the new lead block go back to
the device.

``deflation`` takes gmres_tpu's values, "eig", "subspace" and "auto", and
every one of them runs the exact eigensolver route, because that is what
gmres_tpu's ``gmres_dr`` does: its nested ``def deflation(...)`` rebinds
the argument's name before the ``deflation == "subspace"`` test inside it
reads it, so the test compares a function with a string and the real
subspace iteration never runs there (``gmres_tpu/solvers/gmres_dr.py``,
:217 and :225; ``gcrodr`` has no such clash and runs both routes).

Host reads: one boolean per inner iteration that tests convergence, that
one per cycle, one for the initial residual and one for the exit
certification (``GmresResult.host_syncs``).

The solve is a generator of steps (``gmres_dr_steps``, ``solvers/requests.py``):
``gmres_dr`` drives it on its own, ``solvers/batched.py`` one a lane.
"""

from __future__ import annotations

from typing import Optional

import torch

from gmres_tpu_torch.ops.blas import gram, row_combine, rows_like, tree_vdot
from gmres_tpu_torch.ops.givens import GivensState, givens_step
from gmres_tpu_torch.ops.hessenberg_eig import eig_select
from gmres_tpu_torch.ops.tri import masked_back_substitution, solve_small
from gmres_tpu_torch.solvers.fgmres import _solve_1x1_steps
from gmres_tpu_torch.solvers.gmres import (
    _as_operator,
    _cgs_pass,
    _nonzero_or_one,
    _v_err_mgsr,
)
from gmres_tpu_torch.solvers.requests import Apply, Read, run
from gmres_tpu_torch.types import GmresResult, Preconditioner, SolverStatus

HOST = torch.device("cpu")
F64 = torch.float64


def _resolve_deflation(deflation: str) -> str:
    """The deflation route: "auto" is the exact "eig" route, since the card
    has complex dtypes (gmres_tpu picks "subspace" on a TPU, which has
    none)."""
    if deflation == "auto":
        deflation = "eig"
    if deflation not in ("eig", "subspace"):
        raise ValueError(f"unknown deflation {deflation!r}")
    return deflation


def _realify(vals, vecs, k: int, eps: float):
    """(dim, k) real columns for the k leading harmonic Ritz vectors, and
    which slots hold a conjugate pair's second member: that member takes Im
    of the first (JAX's ``gcrodr._realify`` and the same rule in
    ``gmres_dr``)."""
    ptol = 64.0 * eps
    v = vals[:k]
    mods = v.abs()
    pair_second = ((torch.arange(k) >= 1)
                   & ((v - torch.roll(v, 1).conj()).abs() <= ptol * (mods + 1.0))
                   & (v.imag.abs() > ptol * (mods + 1.0)))
    return torch.where(pair_second[None, :], torch.roll(vecs, 1, dims=1).imag,
                       vecs.real), pair_second


def _harmonic_matrix(hraw: torch.Tensor, m: int) -> torch.Tensor:
    """H + h²_{m+1,m}·f e_mᵀ with f = H⁻ᵀ e_m: the harmonic Ritz matrix of
    the plain Hessenberg (only its last column changes)."""
    hm = hraw[:m, :m]
    em = torch.zeros((m,), dtype=hraw.dtype)
    em[m - 1] = 1.0
    f = solve_small(hm.T, em)
    cmat = hm.clone()
    cmat[:, m - 1] += hraw[m, m - 1] ** 2 * f
    return cmat


def gmres_dr(
    A,
    b: torch.Tensor,
    *,
    restart: int = 30,
    deflate: int = 10,
    tol: float = 1e-8,
    max_restarts: int = 1000,
    M: Optional[Preconditioner] = None,
    x0: Optional[torch.Tensor] = None,
    compute_v_err: bool = False,
    deflation: str = "auto",
) -> GmresResult:
    """Solve A x = b by GMRES-DR(restart, deflate) (the arguments of
    ``gmres_tpu.gmres_dr``).

      restart: subspace dimension m per cycle (deflated vectors plus new
        Krylov directions).
      deflate: harmonic Ritz vectors k kept across restarts (clamped to
        m − 2; 0 is restarted right-preconditioned GMRES).
      M: linear right preconditioner.
      compute_v_err: orthogonality audit of the last cycle's basis.
      deflation: "eig", "subspace" or "auto", validated; each runs the
        exact eigensolver extraction, as in gmres_tpu (module docstring).
    """
    return run(gmres_dr_steps(A, b, restart=restart, deflate=deflate, tol=tol,
                              max_restarts=max_restarts, M=M, x0=x0,
                              compute_v_err=compute_v_err, deflation=deflation))


def gmres_dr_steps(A, b, *, restart=30, deflate=10, tol=1e-8, max_restarts=1000,
                   M=None, x0=None, compute_v_err=False, deflation="auto"):
    """``gmres_dr``'s solve as steps (``solvers/requests.py``), returning its
    GmresResult. The cycle's small state comes back by one ``Read`` (in a
    batched solve one host read for every lane at a cycle's end), and each
    lane's eigensolve runs on its own float64 copy, as its sequential solve
    runs it."""
    op = _as_operator(A, b.device)
    if b.numel() == 1:
        return (yield from _solve_1x1_steps(op, b, x0, tol))
    if x0 is None:
        x0 = torch.zeros_like(b)
    dtype = b.dtype
    dev = b.device
    shape = tuple(b.shape)
    m = min(restart, b.numel() - 1)
    k = max(min(int(deflate), m - 2), 0)
    _resolve_deflation(deflation)
    kb = k + 1  # realification slots (a pair may straddle the cut)
    tiny = torch.finfo(dtype).tiny
    eps = float(torch.finfo(dtype).eps)
    beta0 = torch.sqrt(tree_vdot(b, b))
    cols_kb = torch.arange(kb)

    def apply_m(v):
        return (yield Apply(M, v)) if M is not None else v

    def lead_block(hlead, c_ext, keff):
        """On the host: Ω with Q₀ᵀ of the lead block's QR embedded, the
        rotated rhs, and the first keff columns of the rotated and raw
        Hessenberg. keff = 0 is the identity (an undeflated cycle)."""
        omega = torch.eye(m + 1, dtype=F64)
        hmat = torch.zeros((m + 1, m), dtype=F64)
        hraw = torch.zeros((m + 1, m), dtype=F64)
        if keff > 0:
            eye_kb1 = torch.eye(kb + 1, dtype=F64)
            a0 = torch.where(cols_kb[None, :] < keff, hlead[: kb + 1, :kb],
                             eye_kb1[:, :kb])
            q0, r0 = torch.linalg.qr(torch.cat([a0, eye_kb1[:, kb:]], dim=1),
                                     mode="complete")
            omega[: kb + 1, : kb + 1] = q0.T
            hmat[: kb + 1, :kb] = torch.where(cols_kb[None, :] < keff, r0[:, :kb], 0.0)
            hraw[:, :kb] = torch.where(cols_kb[None, :] < keff, hlead[:, :kb], 0.0)
        return [t.to(dev, dtype) for t in (omega, omega @ c_ext, hmat, hraw)]

    def cycle(v_basis, omega, g, hmat, hraw, keff):
        giv = GivensState(omega=omega, g=g, beta0=torch.clamp(beta0, min=tiny))
        ferr = torch.zeros((m,), dtype=dtype, device=dev)
        syncs = 0
        t = keff
        while True:
            w = yield Apply(op, (yield from apply_m(v_basis[t])))
            h1, w = _cgs_pass(v_basis[: t + 1], w)
            h2, w = _cgs_pass(v_basis[: t + 1], w)
            h_val = torch.sqrt(tree_vdot(w, w))
            hcol = torch.zeros((m + 1,), dtype=dtype, device=dev)
            hcol[: t + 1] = h1 + h2
            hcol[t + 1] = h_val
            hraw[:, t] = hcol
            giv, col, g_next = givens_step(giv, hcol, t)
            hmat[:, t] = col
            rel = g_next.abs() / giv.beta0
            ferr[t] = rel
            v_basis[t + 1] = w / _nonzero_or_one(h_val)
            t += 1
            if t >= m:
                break
            syncs += 1
            if (yield Read((rel < tol) | (h_val < tol))):
                break
        y = masked_back_substitution(hmat, giv.g, t)
        dx = yield from apply_m(row_combine(y, v_basis[:m]))
        return dx, t, ferr, h_val, y, syncs

    def deflate_step(hraw, c_resid, usable):
        """On the host: the next cycle's basis transform, lead block, rhs
        coordinates and k_eff; the undeflated fallback where the deflation
        is unusable."""
        valid = usable
        if usable:
            vals, vecs, ok = eig_select(_harmonic_matrix(hraw, m), kb, which="smallest")
            cols, pair_second = _realify(vals, vecs, kb, eps)
            keff = k + int(pair_second[k])
            cols = torch.where(cols_kb[None, :] < keff, cols, 0.0)
            p_m, _ = torch.linalg.qr(cols)
            p_m = torch.where(cols_kb[None, :] < keff, p_m, 0.0)
            pbar = torch.zeros((m + 1, kb + 1), dtype=F64)
            pbar[:m, :kb] = p_m
            # The residual direction goes to slot keff (CGS2 against P).
            cperp = c_resid - pbar @ (pbar.T @ c_resid)
            cperp = cperp - pbar @ (pbar.T @ cperp)
            cnorm = torch.sqrt(torch.sum(cperp * cperp))
            pbar[:, keff] = cperp / (cnorm if cnorm > 0 else 1.0)
            hlead_small = pbar.T @ (hraw @ p_m)
            hlead = torch.zeros((m + 1, m), dtype=F64)
            hlead[: kb + 1, :kb] = hlead_small
            c_ext = torch.zeros((m + 1,), dtype=F64)
            c_ext[: kb + 1] = pbar.T @ c_resid
            tmat = torch.zeros((m + 1, m + 1), dtype=F64)
            tmat[: kb + 1] = pbar.T
            valid = bool(ok and torch.isfinite(hlead_small).all()
                         and torch.isfinite(c_ext).all()
                         and torch.isfinite(p_m).all() and cnorm > 0)
        if not valid:
            crn = torch.sqrt(torch.sum(c_resid * c_resid))
            keff = 0
            tmat = torch.zeros((m + 1, m + 1), dtype=F64)
            tmat[0] = c_resid / (crn if crn > 0 else 1.0)
            hlead = torch.zeros((m + 1, m), dtype=F64)
            c_ext = torch.zeros((m + 1,), dtype=F64)
            c_ext[0] = crn
        return tmat, hlead, c_ext, keff

    def true_residual(x):
        r = b - (yield Apply(op, x))
        beta = torch.sqrt(tree_vdot(r, r))
        return r, beta, beta / torch.clamp(beta0, min=tiny)

    r_init, beta_init, rel_init = yield from true_residual(x0)
    converged, beta_host = yield Read(torch.stack(
        [((beta0 == 0) | (rel_init < tol)).to(dtype), beta_init]))
    converged = bool(converged)
    syncs = 1
    v_init = rows_like(m + 1, b)
    v_init[0] = r_init / _nonzero_or_one(beta_init)
    c_ext = torch.zeros((m + 1,), dtype=F64)
    c_ext[0] = beta_host
    hlead = torch.zeros((m + 1, m), dtype=F64)
    keff = 0
    x, kcount, n_out, breakdown = x0, 0, 0, False
    ferr = torch.zeros((m,), dtype=dtype, device=dev)
    v_basis = v_init
    while kcount < max_restarts and not converged and not breakdown:
        omega, g, hmat, hraw = lead_block(hlead, c_ext, keff)
        v_basis = v_init
        dx, n_out, ferr, hb, y, inner_syncs = yield from cycle(v_basis, omega, g, hmat,
                                                               hraw, keff)
        syncs += inner_syncs
        x = x + dx
        # The least-squares residual in V_{m+1} coordinates drives the next
        # cycle; it, the Hessenberg and the flags come back in one read.
        c_resid = c_ext.to(dev, dtype) - hraw @ y
        conv = ferr[n_out - 1] < tol
        bd = ((hb < tol) & ~conv) | ~torch.isfinite(c_resid).all()
        host = torch.tensor((yield Read(torch.cat([torch.stack([conv, bd]).to(dtype),
                                                   c_resid, hraw.reshape(-1)]))),
                            dtype=F64, device=HOST)
        syncs += 1
        converged, breakdown = bool(host[0]), bool(host[1])
        kcount += 1
        if kcount < max_restarts and not converged and not breakdown:
            usable = n_out == m and k > 0
            tmat, hlead, c_ext, keff = deflate_step(
                host[m + 3:].reshape(m + 1, m), host[2:m + 3], usable)
            v_init = row_combine(tmat.T.to(dev, dtype), v_basis)

    # Exit certification on the true residual: the deflated coordinate
    # recurrences are not trusted for the final claim.
    _, _, rel_true = yield from true_residual(x)
    certified = yield Read(rel_true < tol * 10.0)
    syncs += 1
    if converged and certified:
        status = SolverStatus.CONVERGED
    elif breakdown or converged:
        status = SolverStatus.BREAKDOWN
    else:
        status = SolverStatus.MAX_ITERATIONS
    residual = rel_true if kcount > 0 else rel_init
    if compute_v_err:
        v_err = _v_err_mgsr(gram(v_basis, v_basis).to(dtype), n_out, dtype)
    else:
        v_err = torch.zeros((m + 1,), dtype=dtype, device=dev)
    return GmresResult(
        x=x, iterations=n_out, restarts=kcount, residual=residual,
        status=int(status), residual_history=ferr, v_err=v_err, host_syncs=syncs,
    )
