"""Chebyshev iteration: the reduction-free SPD solver, in eager PyTorch.

Counterpart of ``gmres_tpu/solvers/chebyshev.py``: restarted correction
form, each cycle applying the order-k Chebyshev approximation of A⁻¹ on
[lam_min, lam_max] to the true residual,

    x ← x + p_k(A)(b − A x),

so the cycle's residual is true by construction. A cycle whose residual
grows past twice the previous one (bounds that miss the spectrum) or is not
finite ends the solve in BREAKDOWN.

With ``coefs`` (a 5-point stencil's coefficients) the polynomial is
``chebyshev_stencil_preconditioner``: on a CUDA tensor one call of kernel
K2 a cycle, and A (K1 for the port's stencil operators) once for the
cycle's residual. Without it, the polynomial is
``chebyshev_preconditioner(A, ..., reference_form=False)``, the
semi-iteration around A.

``lax.while_loop`` becomes a Python loop reading the cycle's residual norm,
the cycle's one reduction, once a cycle (``SolveResult.host_syncs``: the
initial residual and one a cycle).

The loop is a generator of steps (``chebyshev_solve_steps``): each
application of A, and of the polynomial with ``coefs``, and each read is a
request to its runner (``solvers/requests.py``); without ``coefs`` the
polynomial's applications of A are requests one by one. ``chebyshev_solve``
drives it on its own; ``solvers/batched.py`` drives one per lane of a
batched solve (the K2 polynomial one batched call for the lanes).
"""

from __future__ import annotations

import math
from typing import Any, Optional

import torch

from gmres_tpu_torch.ops.blas import tree_norm, tree_sub, tree_zeros_like
from gmres_tpu_torch.ops.fused import chebyshev_k_scalars
from gmres_tpu_torch.precond.chebyshev import chebyshev_stencil_preconditioner
from gmres_tpu_torch.solvers.cg import _in_dtype
from gmres_tpu_torch.solvers.requests import Apply, Read, derived, run
from gmres_tpu_torch.types import LinearOperator, SolveResult, SolverStatus


def chebyshev_solve(
    A: LinearOperator,
    b: Any,
    lam_min: float,
    lam_max: float,
    *,
    order: int = 16,
    tol: float = 1e-9,
    max_cycles: int = 1000,
    x0: Optional[Any] = None,
    coefs=None,
    use_pallas: str = "auto",
) -> SolveResult:
    """Solve A x = b (A SPD with spectrum ⊂ [lam_min, lam_max]) by
    restarted order-``order`` Chebyshev iteration (the arguments of
    ``gmres_tpu.chebyshev_solve``).

      coefs: optional 5-point stencil coefficients (center, W, E, S, N);
        the polynomial then runs as ``chebyshev_stencil_preconditioner``
        (K2 on a CUDA tensor); A is still applied for each cycle's residual.
      use_pallas: passed to ``chebyshev_stencil_preconditioner`` with
        ``coefs``: "auto" and "always" route by device, "never" takes K2's
        plain version.

    ``iterations`` counts cycles; ``residual`` is the absolute true
    ‖b − A x‖₂."""
    return run(chebyshev_solve_steps(A, b, lam_min, lam_max, order=order, tol=tol,
                                     max_cycles=max_cycles, x0=x0, coefs=coefs,
                                     use_pallas=use_pallas))


def _semi_iteration(A, r, theta, pairs):
    """``chebyshev_preconditioner(A, ..., reference_form=False)`` applied to
    r, as steps: each application of A a request."""
    d0 = r / theta
    z = d0
    for a, b in pairs:
        resid = r - (yield Apply(A, z))
        d0 = a * d0 + b * resid
        z = z + d0
    return z


def chebyshev_solve_steps(A, b, lam_min, lam_max, *, order=16, tol=1e-9,
                          max_cycles=1000, x0=None, coefs=None, use_pallas="auto"):
    """``chebyshev_solve``'s solve as steps (``solvers/requests.py``),
    returning its SolveResult."""
    if coefs is not None:
        key = ("chebyshev_solve", lam_min, lam_max, order, tuple(float(c) for c in coefs),
               use_pallas)
        p_k = derived(A, key, lambda _: chebyshev_stencil_preconditioner(
            lam_min, lam_max, order=order, coefs=coefs, use_pallas=use_pallas),
            lanes=False)

        def poly(r):
            return (yield Apply(p_k, r))
    else:
        theta, _, steps = chebyshev_k_scalars(lam_min, lam_max, order)
        pairs = [(steps[2 * s], steps[2 * s + 1]) for s in range(order - 1)]

        def poly(r):
            return (yield from _semi_iteration(A, r, theta, pairs))
    if x0 is None:
        x = tree_zeros_like(b)
        r = b
    else:
        x = x0
        r = tree_sub(b, (yield Apply(A, x0)))
    rdtype = b.real.dtype
    tol = _in_dtype(tol, rdtype)
    res0 = tree_norm(r)
    res_prev = yield Read(res0)
    syncs = 1
    status = int(SolverStatus.CONVERGED if res_prev < tol
                 else SolverStatus.MAX_ITERATIONS)
    res = res0
    history = []
    i = 0
    while i < max_cycles and status == SolverStatus.MAX_ITERATIONS:
        x = x + (yield from poly(r))
        r = tree_sub(b, (yield Apply(A, x)))
        res = tree_norm(r)           # the cycle's one reduction
        res_f = yield Read(res)
        syncs += 1
        history.append(res_f)
        if res_f < tol:
            status = int(SolverStatus.CONVERGED)
        elif not math.isfinite(res_f) or res_f > 2.0 * res_prev:
            status = int(SolverStatus.BREAKDOWN)
        res_prev = res_f
        i += 1
    final = history[-1] if i > 0 else res_prev
    hist = torch.tensor(history + [final] * (max_cycles - i), dtype=rdtype,
                        device=b.device)
    return SolveResult(x=x, iterations=i, residual=res, status=status,
                       residual_history=hist, host_syncs=syncs)
