"""IDR(s), Induced Dimension Reduction (van Gijzen & Sonneveld 2011, the
biorthogonal variant), in eager PyTorch.

Counterpart of ``gmres_tpu/solvers/idrs.py``, with its options and
arithmetic: s direction sweeps per outer iteration, each solving the
trailing s×s system by ``solve_small`` (the full system with the leading
rows and columns masked to the identity) and biorthogonalising against the
leading shadow directions; then the Sonneveld-space step with van Gijzen's
κ-stabilised ω. The projections on the shadow block P are (s, n)·(n,)
products. Convergence: absolute ‖r‖ < tol at outer-iteration boundaries;
the exit recomputes b − A x and certifies on it.

P is s orthonormalised standard-normal directions. JAX draws them from
``PRNGKey(7)``, which torch cannot reproduce: here they come from one
seam, ``_shadow_block`` (a torch.Generator seeded 7, drawn on the CPU, so
the card and the CPU get the same P).

Host reads: one per outer iteration (the status), one for the initial
residual and one for the certification (``SolveResult.host_syncs``).

The loop is a generator of steps (``idrs_steps``): each application of A
or M and each read is a request to its runner (``solvers/requests.py``).
``idrs`` drives it on its own; ``solvers/batched.py`` drives one per lane
of a batched solve, each lane drawing the same P (``jax.vmap`` shares the
closed-over key).
"""

from __future__ import annotations

from typing import Optional

import torch

from gmres_tpu_torch.ops.blas import (
    _orthonormalize_block,
    as_plain,
    row_combine,
    rows_like,
    shard_rows_like,
    tree_norm,
    tree_vdot,
)
from gmres_tpu_torch.ops.tri import solve_small
from gmres_tpu_torch.solvers.requests import Apply, Read, run
from gmres_tpu_torch.types import (
    LinearOperator,
    Preconditioner,
    SolveResult,
    SolverStatus,
)


def _shadow_block(s: int, shape, dtype: torch.dtype, device) -> torch.Tensor:
    """The (s, *shape) shadow block P with orthonormal rows: standard-normal
    draws from a CPU torch.Generator seeded 7 in float64, cast, moved to
    ``device`` and orthonormalised there (SVQB twice)."""
    gen = torch.Generator(device="cpu").manual_seed(7)
    raw = torch.randn((s,) + tuple(shape), generator=gen, dtype=torch.float64)
    p, _ = _orthonormalize_block(raw.to(device=device, dtype=dtype),
                                 float(torch.finfo(dtype).eps))
    return p


def idrs(
    A: LinearOperator,
    b: torch.Tensor,
    *,
    s: int = 4,
    tol: float = 1e-9,
    max_iterations: int = 10_000,
    M: Optional[Preconditioner] = None,
    x0: Optional[torch.Tensor] = None,
) -> SolveResult:
    """Solve A x = b (A nonsymmetric) by preconditioned IDR(s) (the
    arguments of ``gmres_tpu.idrs``).

      s: shadow-space dimension (1 ≈ BiCGSTAB; 4–8 typical).
    ``iterations`` counts outer iterations of s+1 operator applications;
    the history records ‖r‖ per outer iteration.
    """
    if s < 1:
        raise ValueError(f"s must be >= 1, got {s}")
    return run(idrs_steps(A, b, s=s, tol=tol, max_iterations=max_iterations, M=M,
                          x0=x0))


def idrs_steps(A, b, *, s=4, tol=1e-9, max_iterations=10_000, M=None, x0=None):
    """``idrs``'s solve as steps (``solvers/requests.py``), returning its
    SolveResult."""
    if s < 1:
        raise ValueError(f"s must be >= 1, got {s}")
    if x0 is None:
        x = torch.zeros_like(b)
        r = b
    else:
        x = x0
        r = b - (yield Apply(A, x0))
    dtype = b.dtype
    dev = b.device
    rdtype = dtype.to_real()
    history = torch.zeros((max_iterations,), dtype=rdtype, device=dev)
    tiny = torch.finfo(dtype).tiny
    shape = b.shape

    def m_apply(v):
        return (yield Apply(M, v)) if M is not None else v

    # Drawn whole on every rank; a sharded b keeps its rows of it.
    p_flat = shard_rows_like(_shadow_block(s, shape, dtype, dev), b).reshape(s, -1).conj()

    def pdot(v):
        """(P, v): the s inner products as one product."""
        return as_plain(p_flat @ v.reshape(-1))

    def safe_div(num, den):
        return num / torch.where(den.abs() > 0, den, torch.ones_like(den))

    idx = torch.arange(s, device=dev)
    eye = torch.eye(s, dtype=dtype, device=dev)
    res = res0 = tree_norm(r)
    status = (SolverStatus.CONVERGED if (yield Read(res0 < tol))
              else SolverStatus.MAX_ITERATIONS)
    syncs = 1
    g_blk = rows_like(s, b)
    u_blk = rows_like(s, b)
    m_mat = eye.clone()
    om = torch.ones((), dtype=dtype, device=dev)
    i = 0
    while i < max_iterations and status == SolverStatus.MAX_ITERATIONS:
        f = pdot(r)
        for k in range(s):
            # The trailing (s−k) system M[k:, k:] c = f[k:] as the full
            # system masked to the identity: the leading entries of c are
            # exact zeros, so the combinations run over the whole block.
            act = (idx[:, None] >= k) & (idx[None, :] >= k)
            c = solve_small(torch.where(act, m_mat, eye),
                            torch.where(idx >= k, f, torch.zeros_like(f)))
            v = yield from m_apply(r - row_combine(c, g_blk))
            u_k = row_combine(c, u_blk) + om * v
            g_k = yield Apply(A, u_k)
            # Biorthogonalise g_k against the leading shadow directions,
            # the projections updated from one block reduction.
            proj = pdot(g_k)
            for lead in range(k):
                alpha = safe_div(proj[lead], m_mat[lead, lead])
                g_k = g_k - alpha * g_blk[lead]
                u_k = u_k - alpha * u_blk[lead]
                proj = proj - alpha * m_mat[:, lead]
            m_col = pdot(g_k)
            m_mat[:, k] = torch.where(idx >= k, m_col, m_mat[:, k])
            beta = safe_div(f[k], m_mat[k, k])
            r = r - beta * g_k
            x = x + beta * u_k
            f = torch.where(idx > k, f - beta * m_col, torch.zeros_like(f))
            g_blk[k] = g_k
            u_blk[k] = u_k

        # Sonneveld-space step with the κ-stabilised ω.
        v = yield from m_apply(r)
        t = yield Apply(A, v)
        tt = tree_vdot(t, t).real
        tr = tree_vdot(t, r)
        om_raw = safe_div(tr, tt.to(dtype))
        kappa = tr.abs() / torch.clamp(torch.sqrt(tt) * tree_norm(r), min=tiny)
        om = torch.where(kappa < 0.7,
                         om_raw * safe_div(torch.full_like(kappa, 0.7), kappa), om_raw)
        x = x + om * v
        r = r - om * t
        res = tree_norm(r)
        history[i] = res
        code = torch.where(res < tol, 0, torch.where(torch.isfinite(res), 1, 2))
        status = SolverStatus((yield Read(code)))
        syncs += 1
        i += 1

    # Exit certification on the recomputed residual.
    true_res = tree_norm(b - (yield Apply(A, x)))
    missed = yield Read(true_res >= tol)
    syncs += 1
    if status == SolverStatus.CONVERGED and missed:
        status = SolverStatus.BREAKDOWN
    res = true_res if i > 0 else res0
    history[i:] = res
    return SolveResult(x=x, iterations=i, residual=res, status=int(status),
                       residual_history=history, host_syncs=syncs)
