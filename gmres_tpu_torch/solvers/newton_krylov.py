"""Jacobian-free Newton-Krylov (JFNK) for nonlinear systems F(x) = 0, in
eager PyTorch.

Counterpart of ``gmres_tpu/solvers/newton_krylov.py``: inexact Newton with
Eisenstat–Walker choice-2 forcing terms, inner GMRES (right-preconditioned
FGMRES when M is given) or GCRO-DR with its recycle space carried across
Newton steps, and Armijo backtracking on ‖F‖. The same forcing, line
search, statuses and ``inner_iterations`` count.

The Jacobian action. gmres_tpu linearises F once a Newton step
(``jax.linearize``) and applies the linear tangent map per inner matvec.
``torch.func.linearize`` traces with fake tensors, which a ctypes kernel
launch cannot take, so here J·v is ``torch.func.jvp(F, (x,), (v,))``: F is
evaluated again with every J·v. For a stencil residual (the Bratu residual,
``models/bratu.py``) on a CUDA tensor that is two K1 launches a J·v — the
primal, and the tangent through K1's jvp rule — and one more ``exp``, where
gmres_tpu's tangent map is one fused stencil. F is a user callable, so no
tangent map is cached. ``NewtonResult.jv_products`` counts the J·v. On a
sharded x (a DTensor) J·v is ``parallel/halo.py:blockwise_jvp``: the jvp
runs on each rank's block, its stencils on their halo forms (two exchanges
and, on the card, two K1 halo-form launches a J·v for the Bratu residual).

Host reads: the Newton loop reads ‖F‖ once a trial point (and once at the
start); the inner solves read what their own ``host_syncs`` count.
``NewtonResult.host_syncs`` is the sum.

The loop is a generator of steps (``newton_krylov_steps``): each
evaluation of F and each J·v is a request to its runner
(``solvers/requests.py``), J·v an application of one function of F (``_jv``)
at the step's linearisation point, the inner GMRES or FGMRES solve its own
steps. ``newton_krylov`` drives it on its own; ``solvers/batched.py``
drives one per lane of a batched solve (gmres_tpu's ``jax.vmap`` of a
Newton solve, its λ-sweep of the Bratu problem): each J·v of the lanes is
then one ``torch.func.vmap`` of ``torch.func.jvp``, the lanes' stencils one
batched K1 launch for the primal and one for the tangent (K1's jvp rule
under vmap, ``ops/stencil.py:Stencil5Grid``).
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from gmres_tpu_torch.ops.blas import is_dtensor, tree_norm
from gmres_tpu_torch.solvers.cg import _in_dtype
from gmres_tpu_torch.solvers.requests import Apply, At, Read, derived, run
from gmres_tpu_torch.types import NewtonResult, Preconditioner, SolverStatus

_ALPHA_EW = (1.0 + 5.0 ** 0.5) / 2.0  # Eisenstat–Walker choice-2 power


def newton_krylov(
    F: Callable,
    x0: torch.Tensor,
    *,
    tol: float = 1e-9,
    max_newton: int = 50,
    M: Optional[Preconditioner] = None,
    inner: str = "gmres",
    recycle_k: int = 10,
    restart: int = 30,
    max_restarts: int = 40,
    variant: str = "householder",
    inner_dtype=None,
    forcing: str = "ew",
    eta0: float = 0.5,
    eta_fixed: float = 1e-4,
    eta_min: float = 1e-10,
    eta_max: float = 0.9,
    gamma: float = 0.9,
    line_search: bool = True,
    max_backtracks: int = 25,
    armijo: float = 1e-4,
) -> NewtonResult:
    """Solve F(x) = 0 by inexact Newton with Krylov inner solves.

    The arguments are those of ``gmres_tpu.newton_krylov``. F must be
    differentiable by ``torch.func.jvp`` (plain torch, or K1's full-grid
    route on the card); M is applied on the right through FGMRES with the
    gmres inner (on the left with gcrodr); ``inner_dtype`` (gmres inner
    only) runs the inner basis in that dtype, J·v itself at x's dtype.
    ``iterations`` counts Newton steps; ``residual`` is ‖F(x)‖₂ at the
    returned x."""
    return run(newton_krylov_steps(
        F, x0, tol=tol, max_newton=max_newton, M=M, inner=inner, recycle_k=recycle_k,
        restart=restart, max_restarts=max_restarts, variant=variant,
        inner_dtype=inner_dtype, forcing=forcing, eta0=eta0, eta_fixed=eta_fixed,
        eta_min=eta_min, eta_max=eta_max, gamma=gamma, line_search=line_search,
        max_backtracks=max_backtracks, armijo=armijo))


def _jv(F: Callable) -> Callable:
    """J·v of F as a function of (v, x_lin, *lane_args): the tangent of
    u ↦ F(u, *lane_args) at x_lin along v, at x_lin's dtype and returned in
    v's (``torch.func.jvp``; ``blockwise_jvp`` on a DTensor x_lin)."""
    def jv(v, x_lin, *lane_args):
        f = (lambda u: F(u, *lane_args)) if lane_args else F
        if is_dtensor(x_lin):
            from gmres_tpu_torch.parallel.halo import blockwise_jvp

            return blockwise_jvp(f, x_lin, v.to(x_lin.dtype)).to(v.dtype)
        _, t = torch.func.jvp(f, (x_lin,), (v.to(x_lin.dtype),))
        return t.to(v.dtype)

    return jv


def newton_krylov_steps(F, x0, *, tol=1e-9, max_newton=50, M=None, inner="gmres",
                        recycle_k=10, restart=30, max_restarts=40,
                        variant="householder", inner_dtype=None, forcing="ew",
                        eta0=0.5, eta_fixed=1e-4, eta_min=1e-10, eta_max=0.9,
                        gamma=0.9, line_search=True, max_backtracks=25,
                        armijo=1e-4):
    """``newton_krylov``'s solve as steps (``solvers/requests.py``),
    returning its NewtonResult."""
    from gmres_tpu_torch.solvers.fgmres import fgmres_steps
    from gmres_tpu_torch.solvers.gcrodr import gcrodr_steps
    from gmres_tpu_torch.solvers.gmres import gmres_steps

    if forcing not in ("ew", "fixed"):
        raise ValueError(f"unknown forcing {forcing!r}")
    if inner not in ("gmres", "gcrodr"):
        raise ValueError(f"unknown inner {inner!r}")
    use_recycling = inner == "gcrodr"
    if use_recycling and inner_dtype is not None:
        raise ValueError("inner_dtype (mixed precision) applies to the gmres inner only")

    dtype = x0.dtype
    rdtype = x0.real.dtype if x0.is_complex() else dtype
    tiny = torch.finfo(rdtype).tiny
    tol_r = _in_dtype(tol, rdtype)
    f0 = yield Apply(F, x0)
    if f0.shape != x0.shape:
        raise ValueError(f"F must map x to a residual of the same shape; got "
                         f"{tuple(x0.shape)} -> {tuple(f0.shape)}")
    fnorm = tree_norm(f0)
    fnorm_f = yield Read(fnorm)
    syncs = 1
    status = int(SolverStatus.CONVERGED if fnorm_f < tol_r
                 else SolverStatus.MAX_ITERATIONS)

    def forcing_term(i, fnorm_f, fnorm_prev_f, eta_prev):
        if forcing == "fixed":
            return _in_dtype(eta_fixed, rdtype)
        if i == 0:
            eta = _in_dtype(eta0, rdtype)
        else:
            ratio = fnorm_f / max(fnorm_prev_f, tiny)
            eta_raw = gamma * ratio ** _ALPHA_EW
            safeguard = gamma * eta_prev ** _ALPHA_EW
            eta = max(eta_raw, safeguard) if safeguard > 0.1 else eta_raw
        # Oversolve guard (Eisenstat–Walker §6): never tighter than what
        # reaching tol requires.
        eta = max(eta, 0.5 * tol / max(fnorm_f, tol))
        return _in_dtype(min(max(eta, eta_min), eta_max), rdtype)

    jv_of_f = derived(F, "jv", _jv)
    x, fx = x0, f0
    fnorm_prev_f = fnorm_f
    eta_prev = _in_dtype(eta0, rdtype)
    inner_tot = 0
    jv_products = 0
    u_rec = (torch.zeros((recycle_k,) + tuple(x0.shape), dtype=dtype, device=x0.device)
             if use_recycling else None)
    history = []
    i = 0
    while i < max_newton and status == SolverStatus.MAX_ITERATIONS:
        j_apply = At(jv_of_f, x)
        eta = forcing_term(i, fnorm_f, fnorm_prev_f, eta_prev)
        if use_recycling:
            res = yield from gcrodr_steps(j_apply, -fx, k=recycle_k, restart=restart,
                                          tol=eta, max_restarts=max_restarts, M=M,
                                          recycle=u_rec)
            u_rec = res.recycle
            # + recycle_k: the per-step import (op·U to rebuild C).
            inner_tot += recycle_k + (max(res.restarts - 1, 0) * (restart - recycle_k)
                                      + res.iterations)
        else:
            if M is not None:
                res = yield from fgmres_steps(
                    j_apply, -fx, restart=restart, tol=eta, max_restarts=max_restarts,
                    M=M, inner_dtype=inner_dtype, breakdown_check=False)
            else:
                res = yield from gmres_steps(
                    j_apply, -fx, restart=restart, tol=eta, max_restarts=max_restarts,
                    variant=variant, inner_dtype=inner_dtype, compute_v_err=False,
                    breakdown_check=False)
            inner_tot += max(res.restarts - 1, 0) * restart + res.iterations
        jv_products += j_apply.calls
        syncs += res.host_syncs
        d = res.x

        def trial(t):
            xt = x + _in_dtype(t, dtype) * d
            ft = yield Apply(F, xt)
            return xt, ft, tree_norm(ft)

        def accepted_at(t, nt_f):
            return nt_f <= (1.0 - armijo * t) * fnorm_f and math.isfinite(nt_f)

        t = 1.0
        xt, ft, nt = yield from trial(t)
        nt_f = yield Read(nt)
        syncs += 1
        if line_search:
            k = 0
            while not accepted_at(t, nt_f) and k < max_backtracks:
                t *= 0.5
                k += 1
                xt, ft, nt = yield from trial(t)
                nt_f = yield Read(nt)
                syncs += 1
            accepted = accepted_at(t, nt_f)
        else:
            accepted = math.isfinite(nt_f)

        fnorm_prev_f, eta_prev = fnorm_f, eta
        if accepted:
            x, fx, fnorm, fnorm_f = xt, ft, nt, nt_f
        history.append(fnorm_f)
        if fnorm_f < tol_r:
            status = int(SolverStatus.CONVERGED)
        if status == SolverStatus.MAX_ITERATIONS and not accepted:
            status = int(SolverStatus.BREAKDOWN)
        i += 1

    hist = torch.tensor(history + [fnorm_f] * (max_newton - i), dtype=rdtype,
                        device=x0.device)
    return NewtonResult(x=x, iterations=i, residual=fnorm, status=status,
                        residual_history=hist, inner_iterations=inner_tot,
                        host_syncs=syncs, jv_products=jv_products)
