"""QMR (Freund–Nachtigal 1991), quasi-minimal residual by two-sided
Lanczos, in eager PyTorch.

Counterpart of ``gmres_tpu/solvers/qmr.py`` (the Templates formulation,
both Lanczos vectors kept unit-norm every step), with the same update
order, reductions and exits. An iteration applies the (preconditioned)
operator once and its transpose once.

The transpose. gmres_tpu derives (M∘A)ᵀ with ``jax.linear_transpose``;
here it is the pullback of ``torch.func.vjp`` of the operator at b, called
once an iteration. On a CUDA tensor a stencil operator (K1's full-grid
route, ``ops/stencil.py:Stencil5Grid``) has a backward rule: one K1 launch
with the mirrored coefficients. So a QMR solve on a stencil launches K1
once for the vjp's primal at setup, twice an iteration (A p and Aᵀ q) and
once for the certification. No other kernel has a transpose rule yet:
a multigrid cycle (K1's V-cycle forms and K2) as M raises on the card when
its transpose would be derived — pass ``MT=`` (the convdiff cycle's
``transpose=True``) or ``AT=``. On a CPU tensor the cycle is plain torch,
whose transpose torch derives: the CPU runs there, where gmres_tpu cannot
transpose the cycle's ``fori_loop`` (ROADMAP queue 3).

One host read an iteration: ‖r‖ and the breakdown tests come back in one
stacked tensor. ``SolveResult.host_syncs`` counts the reads: the initial
residual, one per iteration and the certification.

The loop is a generator of steps (``qmr_steps``): each application of A, M,
their transposes and each read is a request to its runner
(``solvers/requests.py``). ``qmr`` drives it on its own;
``solvers/batched.py`` drives one per lane of a batched solve, where the
lanes' transposes of one operator are one pullback of the vmapped operator
(on a stencil one K1 launch with each lane's mirrored coefficients,
``ops/stencil.py:Stencil5Lanes``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from gmres_tpu_torch.ops.blas import tree_norm, tree_vdot
from gmres_tpu_torch.solvers.cg import _in_dtype
from gmres_tpu_torch.solvers.requests import (  # noqa: F401 (derived_transpose)
    Apply,
    Read,
    composed,
    derived_transpose,
    run,
    transposed,
)
from gmres_tpu_torch.types import (
    LinearOperator,
    Preconditioner,
    SolveResult,
    SolverStatus,
)


def _safe(d: torch.Tensor) -> torch.Tensor:
    """d where |d| > 0, else 1 (a guarded divisor)."""
    return torch.where(d.abs() > 0, d, torch.ones_like(d))


def qmr(
    A: LinearOperator,
    b: torch.Tensor,
    *,
    tol: float = 1e-9,
    max_iterations: int = 10_000,
    M: Optional[Preconditioner] = None,
    x0: Optional[torch.Tensor] = None,
    AT=None,
    MT=None,
) -> SolveResult:
    """Solve A x = b (A real nonsymmetric) by QMR.

    The arguments are those of ``gmres_tpu.qmr``; b's device is the
    solve's. ``tol`` is an absolute ‖r‖₂ target, certified on the true
    (preconditioned) residual at exit. M is a left preconditioner: the
    solve runs on M∘A. ``AT`` is the transpose of the preconditioned
    operator (M∘A)ᵀ, derived when omitted; ``MT`` the transpose of M alone,
    with which (M∘A)ᵀ = Aᵀ∘Mᵀ is composed and only Aᵀ derived. Complex b
    raises ValueError, as in gmres_tpu."""
    return run(qmr_steps(A, b, tol=tol, max_iterations=max_iterations, M=M, x0=x0,
                         AT=AT, MT=MT))


def qmr_steps(A, b, *, tol=1e-9, max_iterations=10_000, M=None, x0=None, AT=None,
              MT=None):
    """``qmr``'s solve as steps (``solvers/requests.py``), returning its
    SolveResult. Aᵀ (or (M∘A)ᵀ) is ``requests.transposed``: in a batched
    solve one pullback for the lanes that ask together."""
    if b.is_complex():
        raise ValueError("qmr supports real dtypes only")
    dtype = b.dtype
    tol = _in_dtype(tol, dtype)

    def op(v):
        av = yield Apply(A, v)
        return (yield Apply(M, av)) if M is not None else av

    if AT is None:
        if MT is not None and M is not None:
            a_t = transposed(A, b)

            def apply_t(u):
                return (yield Apply(a_t, (yield Apply(MT, u))))
        else:
            op_t = transposed(composed(M, A) if M is not None else A, b)

            def apply_t(u):
                return (yield Apply(op_t, u))
    else:
        def apply_t(u):
            return (yield Apply(AT, u))

    rhs = (yield Apply(M, b)) if M is not None else b
    x = torch.zeros_like(rhs) if x0 is None else x0
    r = rhs - (yield from op(x)) if x0 is not None else rhs
    beta0 = tree_norm(r)
    beta0_f = yield Read(beta0)
    syncs = 1
    zero_v = torch.zeros_like(r)
    one = torch.ones((), dtype=dtype, device=b.device)
    z = torch.zeros((), dtype=dtype, device=b.device)
    status = int(SolverStatus.CONVERGED if beta0_f < tol
                 else SolverStatus.MAX_ITERATIONS)

    v_t, w_t, p, q, d, s = r, r, zero_v, zero_v, zero_v, zero_v
    rho, xi, gamma, eta, eps_prev, theta_prev = beta0, beta0, one, -one, one, z
    history = []
    i = 0
    while i < max_iterations and status == SolverStatus.MAX_ITERATIONS:
        first = i == 0
        v = v_t / _safe(rho)
        w = w_t / _safe(xi)
        delta = tree_vdot(w, v)
        coef_p = z if first else xi * delta / _safe(eps_prev)
        coef_q = z if first else rho * delta / _safe(eps_prev)
        p = v - coef_p * p
        q = w - coef_q * q
        p_t = yield from op(p)
        eps_i = tree_vdot(q, p_t)
        beta = eps_i / _safe(delta)
        v_t = p_t - beta * v
        w_t = (yield from apply_t(q)) - beta * w
        rho_next = tree_norm(v_t)
        xi_next = tree_norm(w_t)
        theta = rho_next / _safe(gamma * beta.abs())
        gamma_new = 1.0 / torch.sqrt(1.0 + theta * theta)
        eta_new = -eta * rho * gamma_new * gamma_new / _safe(beta * gamma * gamma)
        tg2 = z if first else (theta_prev * gamma_new) ** 2
        d = eta_new * p + tg2 * d
        s = eta_new * p_t + tg2 * s
        x = x + d
        r = r - s
        resid = tree_norm(r)
        resid_f, delta_f, eps_f, rho_f, xi_f, beta_f = yield Read(torch.stack(
            [resid, delta, eps_i, rho_next, xi_next, beta]))
        syncs += 1
        history.append(resid_f)
        if resid_f < tol:
            status = int(SolverStatus.CONVERGED)
        # Serious breakdowns only: exact zeros or non-finite values (the
        # benign near-breakdown the recurrence sails through is kept).
        breakdown = (delta_f == 0 or eps_f == 0 or rho_f == 0 or xi_f == 0
                     or not math.isfinite(resid_f) or not math.isfinite(beta_f))
        if status == SolverStatus.MAX_ITERATIONS and breakdown:
            status = int(SolverStatus.BREAKDOWN)
        rho, xi, gamma, eta, eps_prev, theta_prev = (
            rho_next, xi_next, gamma_new, eta_new, eps_i, theta)
        i += 1

    # Certify the true (preconditioned) residual.
    res_true = tree_norm(rhs - (yield from op(x)))
    res_f = yield Read(res_true)
    syncs += 1
    if status == SolverStatus.CONVERGED and res_f >= tol:
        status = int(SolverStatus.BREAKDOWN)
    hist = torch.tensor(history + [res_f] * (max_iterations - i), dtype=dtype,
                        device=b.device)
    return SolveResult(x=x, iterations=i, residual=res_true, status=status,
                       residual_history=hist, host_syncs=syncs)
