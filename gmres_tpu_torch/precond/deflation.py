"""Coarse-space (deflation) preconditioning: remove known slow modes.

Counterpart of ``gmres_tpu/precond/deflation.py``: the balanced (BNN,
A-DEF2) form

    P = Q + (I − Q A) M (I − A Q),       Q = W G⁻¹ Wᵀ,  G = Wᵀ A W,

symmetric positive definite whenever M is, so it composes with CG and
MINRES and stacks on any M (Chebyshev, multigrid, Jacobi).

At build time A·W is applied once per row of W (JAX's ``jax.vmap(A)``;
on the card each row launches A's kernels once) and G is factored once by
``torch.linalg.cholesky_ex`` (no host read: a factor that fails is NaN, as
JAX's ``cho_factor`` gives NaN). An application makes two k-row
contractions, two k-row combinations and two (k, k) Cholesky solves, and
applies M once; it reads nothing back from the device.

On a row-sharded r (a DTensor) W and A·W are placed as a block of rows is,
``[Shard(1)]`` (``ops/blas.py:shard_rows_like``: each rank keeps its own
rows, no message), once per mesh: each contraction Wᵀr and (AW)ᵀz is one
all-reduce of k values, the combinations are local.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from gmres_tpu_torch.ops.blas import (
    is_dtensor,
    per_mesh,
    refuse_row_block,
    row_apply,
    row_combine,
    row_contract,
    shard_rows_like,
)
from gmres_tpu_torch.types import LinearOperator, Preconditioner


def _cho_factor(g: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of g, NaN where the factorisation fails
    (JAX's ``cho_factor``), with no host read."""
    chol, info = torch.linalg.cholesky_ex(g)
    return torch.where(info == 0, chol, torch.full_like(chol, float("nan")))


def coarse_space_preconditioner(
    A: LinearOperator,
    W: torch.Tensor,
    M: Optional[Preconditioner] = None,
) -> Preconditioner:
    """The BNN coarse-space preconditioner from a (k, *shape) block W of
    (approximate) eigenvectors (the arguments of the JAX function).

      A: the SPD operator the solver is given.
      W: (k, *shape) stacked coarse vectors, linearly independent (G = WᵀAW
        is factored), not necessarily orthonormal.
      M: optional inner preconditioner; None is pure deflation.

    Returns z = P(r), SPD whenever M is. ValueError unless W is (k, *shape)
    with k ≥ 1."""
    if W.ndim < 2:
        raise ValueError(
            f"W must be (k, *shape) with k >= 1, got shape {tuple(W.shape)}"
        )
    aw = row_apply(A, W)                                   # (k, *shape), once
    k = W.shape[0]
    g = W.reshape(k, -1) @ aw.reshape(k, -1).T         # (k, k) = WᵀAW
    chol = _cho_factor(g)

    def solve_g(rhs):
        return torch.cholesky_solve(rhs[:, None], chol)[:, 0]

    placed = {}

    def blocks(r):
        """(W, AW), placed as a block of r's rows is, once per mesh."""
        if not is_dtensor(r):
            return W, aw
        return per_mesh(placed, r.device_mesh,
                        lambda _: (shard_rows_like(W, r), shard_rows_like(aw, r)))

    def apply(r):
        # Not marked by row_blocks: reductions over the mesh (ROADMAP queue 2).
        refuse_row_block("the deflation application", r)
        W, aw = blocks(r)
        y = solve_g(row_contract(W, r))                # G⁻¹ Wᵀ r
        # (I − A Q) r, with A·(W c) = (AW)·c: no operator call.
        t = r - row_combine(y, aw)
        z = M(t) if M is not None else t
        # (I − Q A) z = z − W G⁻¹ (AW)ᵀ z (A symmetric).
        y2 = solve_g(row_contract(aw, z))
        return z - row_combine(y2, W) + row_combine(y, W)   # + Q r

    return apply


def _mode_order(nsize: int) -> np.ndarray:
    """The (i, j) pairs, 1-based, in the JAX function's order: sorted by
    (λ, i, j) with λ = sin²(iπ/2(N+1)) + sin²(jπ/2(N+1)) in float64."""
    idx = np.arange(1, nsize + 1)
    s2 = np.sin(idx * np.pi / (2 * (nsize + 1))) ** 2
    ii, jj = np.meshgrid(idx, idx, indexing="ij")
    lam = s2[ii - 1] + s2[jj - 1]
    order = np.lexsort((jj.ravel(), ii.ravel(), lam.ravel()))
    return np.stack([ii.ravel()[order], jj.ravel()[order]], axis=1)


def dirichlet_poisson_modes(nsize: int, k: int, dtype=torch.float64,
                            device="cuda") -> torch.Tensor:
    """The k lowest closed-form eigenvectors of the 2-D 5-point Dirichlet
    Laplacian as a (k, nsize, nsize) block of unit vectors, on ``device``
    (the card unless the caller asks for the CPU): the exact coarse space
    for ``coarse_space_preconditioner`` on ``poisson_operator`` grids. The
    modes are ordered as the JAX function orders them, by (λ, i, j); here
    the order is one numpy sort, not a Python loop over the N² pairs."""
    pairs = _mode_order(nsize)[:k]
    grid = torch.arange(1, nsize + 1, dtype=dtype, device=device)
    i = torch.as_tensor(pairs[:, 0] * math.pi, dtype=dtype, device=device)
    j = torch.as_tensor(pairs[:, 1] * math.pi, dtype=dtype, device=device)
    sx = torch.sin(i[:, None] * grid[None, :] / (nsize + 1))
    sy = torch.sin(j[:, None] * grid[None, :] / (nsize + 1))
    v = sx[:, :, None] * sy[:, None, :]
    norms = torch.sqrt(torch.sum(v * v, dim=(1, 2)))
    return v / norms[:, None, None]
