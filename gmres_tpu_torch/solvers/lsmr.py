"""LSMR (Fong & Saunders 2011): least squares min ‖Ax − b‖₂ with monotone
‖Aᴴr‖, in eager PyTorch.

Counterpart of ``gmres_tpu/solvers/lsmr.py``: MINRES on the normal
equations over the same Golub–Kahan bidiagonalisation as LSQR
(``solvers/lsqr.py``), with the same rotations (Q̂ for the damping row, Q
against the bidiagonal, Q̄ against R), the ‖r‖ estimate of Fong–Saunders
§5.2, stopping tests and certification. The adjoint is derived as in LSQR
(the pullback of ``torch.func.vjp``, already Aᴴ for a complex operator),
with the same K1 launches on a CUDA stencil: one at setup, two an
iteration, two at the certification.

The scalar state stays on the device as 0-d tensors; one host read an
iteration brings back the two stopping estimates. ``host_syncs`` counts
the reads: one at setup, one per iteration and one at the certification.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from gmres_tpu_torch.ops.blas import tree_zeros_like
from gmres_tpu_torch.solvers.cg import _in_dtype
from gmres_tpu_torch.solvers.lsqr import _certify, _normalize
from gmres_tpu_torch.solvers.requests import Apply, Read, run, transposed
from gmres_tpu_torch.types import SolveResult, SolverStatus


def lsmr(
    A: Callable,
    b: torch.Tensor,
    *,
    x_like: Optional[torch.Tensor] = None,
    AH: Optional[Callable] = None,
    tol: float = 1e-9,
    atol: Optional[float] = None,
    max_iterations: int = 10_000,
    damp: float = 0.0,
) -> SolveResult:
    """Minimise ‖A x − b‖₂ (+ damp²‖x‖² when damp > 0).

    The arguments are those of ``gmres_tpu.lsmr``: ``tol`` the absolute ‖r‖
    stop (with damp > 0, of the augmented residual ‖(b − Ax; damp·x)‖),
    ``atol`` (default tol) the absolute ‖Aᴴr − damp²x‖ stop, estimated by
    the monotone |ζ̄|; ``AH`` the adjoint (derived when omitted).
    ``iterations`` counts bidiagonalisation steps; ``residual`` is the
    certified ‖b − Ax‖₂ and ``residual_history`` the ‖r‖ estimates."""
    return run(lsmr_steps(A, b, x_like=x_like, AH=AH, tol=tol, atol=atol,
                          max_iterations=max_iterations, damp=damp))


def lsmr_steps(A, b, *, x_like=None, AH=None, tol=1e-9, atol=None,
               max_iterations=10_000, damp=0.0):
    """``lsmr``'s solve as steps (``solvers/requests.py``), returning its
    SolveResult. Aᴴ is ``requests.transposed`` when derived: in a batched
    solve one pullback for the lanes that ask together."""
    if x_like is None:
        x_like = b
    if atol is None:
        atol = tol
    rdtype = b.real.dtype if b.is_complex() else b.dtype
    tol, atol = _in_dtype(tol, rdtype), _in_dtype(atol, rdtype)
    if AH is None:
        AH = transposed(A, x_like)
    dev = b.device
    tiny = torch.finfo(rdtype).tiny

    def safe(t):
        return torch.clamp(t, min=tiny)

    x = tree_zeros_like(x_like)
    u, beta1 = _normalize(b)
    v, alpha1 = _normalize((yield Apply(AH, u)))
    zetabar = alpha1 * beta1  # ‖Aᴴr₀‖
    beta1_f, zetabar0_f = yield Read(torch.stack([beta1, zetabar]))
    syncs = 1
    status = int(SolverStatus.CONVERGED if (beta1_f < tol or zetabar0_f < atol)
                 else SolverStatus.MAX_ITERATIONS)
    lam = torch.tensor(damp, dtype=rdtype, device=dev)
    one = torch.ones((), dtype=rdtype, device=dev)
    zero = torch.zeros((), dtype=rdtype, device=dev)
    # Scalar state, Fong–Saunders Alg. 1 and the §5 residual recurrences.
    alpha, alphabar = alpha1, alpha1
    zeta, rho, rhobar, cbar, sbar = zero, one, one, one, zero
    betadd, betad, rhodold, tautildeold, thetatilde, d = beta1, zero, one, zero, zero, zero
    h, hbar = v, tree_zeros_like(x)
    history = []
    i = 0
    while i < max_iterations and status == SolverStatus.MAX_ITERATIONS:
        # Golub–Kahan step: β u ← A v − α u ; α v ← Aᴴ u − β v.
        u, beta = _normalize((yield Apply(A, v)) - alpha * u)
        v, alpha_n = _normalize((yield Apply(AH, u)) - beta * v)

        # Q̂ folds the damping row into the bidiagonal.
        alphahat = torch.hypot(alphabar, lam)
        chat = alphabar / safe(alphahat)
        shat = lam / safe(alphahat)

        # Q eliminates β against the (damped) diagonal.
        rhoold = rho
        rho = torch.hypot(alphahat, beta)
        c = alphahat / safe(rho)
        s = beta / safe(rho)
        thetanew = s * alpha_n
        alphabar = c * alpha_n

        # Q̄ (the MINRES-side QR against R).
        rhobarold = rhobar
        zetaold = zeta
        thetabar = sbar * rho
        rhotemp = cbar * rho
        rhobar = torch.hypot(rhotemp, thetanew)
        cbar = rhotemp / safe(rhobar)
        sbar = thetanew / safe(rhobar)
        zeta = cbar * zetabar
        zetabar = -sbar * zetabar

        # Long-vector updates.
        hbar = h - (thetabar * rho / safe(rhoold * rhobarold)) * hbar
        x = x + (zeta / safe(rho * rhobar)) * hbar
        h = v - (thetanew / safe(rho)) * h

        # ‖r‖ estimate (§5.2): the rhs rotated through Q̂, Q and the tilde
        # rotations that track the lower-bidiagonal factor of R̄.
        betaacute = chat * betadd
        betacheck = -shat * betadd  # the component lost to the damping rows
        betahat = c * betaacute
        betadd = -s * betaacute

        thetatildeold = thetatilde
        rhotildeold = torch.hypot(rhodold, thetabar)
        ctildeold = rhodold / safe(rhotildeold)
        stildeold = thetabar / safe(rhotildeold)
        thetatilde = stildeold * rhobar
        rhodold = ctildeold * rhobar
        betad = -stildeold * betad + ctildeold * betahat

        tautildeold = (zetaold - thetatildeold * tautildeold) / safe(rhotildeold)
        taud = (zeta - thetatilde * tautildeold) / safe(rhodold)
        d = d + betacheck * betacheck
        res_est = torch.sqrt(d + (betad - taud) ** 2 + betadd * betadd)
        arnorm = zetabar.abs()  # the monotone ‖Aᴴr − damp²x‖ estimate
        alpha = alpha_n

        res_f, ar_f = yield Read(torch.stack([res_est, arnorm]))
        syncs += 1
        history.append(res_f)
        if res_f < tol or ar_f < atol:
            status = int(SolverStatus.CONVERGED)
        if status == SolverStatus.MAX_ITERATIONS and not math.isfinite(res_f):
            status = int(SolverStatus.BREAKDOWN)
        i += 1

    res_true, res_f, status = yield from _certify(A, AH, b, x, lam, tol, atol,
                                                      status)
    syncs += 1
    res, res_f = (res_true, res_f) if i > 0 else (beta1, beta1_f)
    hist = torch.tensor(history + [res_f] * (max_iterations - i), dtype=rdtype,
                        device=dev)
    return SolveResult(x=x, iterations=i, residual=res, status=status,
                       residual_history=hist, host_syncs=syncs)
