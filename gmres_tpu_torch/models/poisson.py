"""2-D Poisson model problem: 5-point Laplacian with homogeneous Dirichlet
boundaries (by truncation).

Counterpart of ``gmres_tpu/models/poisson.py``. Grids are C-order (N, N)
tensors, as in the JAX package, so Krylov iteration counts match. The
operator routes by device like ``stencil_5pt_routed``: a CUDA tensor goes
through kernel K1 (the JAX operator is the plain jnp stencil, which is the
same computation).
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from gmres_tpu_torch.ops.blas import row_blocks
from gmres_tpu_torch.ops.stencil import stencil_5pt_routed


@row_blocks
def poisson_apply(x: torch.Tensor) -> torch.Tensor:
    """y = A·x for the 5-point Laplacian; x is (N, N) or flat (N²,)."""
    if x.dim() == 1:
        n = int(round(x.shape[0] ** 0.5))
        return stencil_5pt_routed(x.reshape(n, n)).reshape(-1)
    return stencil_5pt_routed(x)


def poisson_operator(nsize: int, flat: bool = False) -> Callable:
    """The matrix-free operator closure for an nsize×nsize grid."""
    if flat:
        def apply_flat(x: torch.Tensor) -> torch.Tensor:
            return stencil_5pt_routed(x.reshape(nsize, nsize)).reshape(-1)
        return apply_flat
    return stencil_5pt_routed


def poisson_spectral_bounds(nsize: int) -> tuple:
    """Exact extreme eigenvalues of the N²×N² 5-point Laplacian."""
    s_min = math.sin(math.pi / (2 * (nsize + 1)))
    s_max = math.sin(nsize * math.pi / (2 * (nsize + 1)))
    return 8.0 * s_min * s_min, 8.0 * s_max * s_max


def tuned_poisson_preconditioner(nsize: int, aggressiveness: float = 30.0):
    """Deep Chebyshev preconditioner auto-sized for an nsize×nsize grid:
    the interval's low end at aggressiveness·λ_min, order
    ≈ 1.6·√(λ_max/lo). Returns (M, order, lo, hi)."""
    from gmres_tpu_torch.precond.chebyshev import (
        chebyshev_stencil_preconditioner,
    )

    lam_min, lam_max = poisson_spectral_bounds(nsize)
    lo = min(aggressiveness * lam_min, lam_max / 16.0)
    order = max(2, int(math.ceil(1.6 * math.sqrt(lam_max / lo))))
    m = chebyshev_stencil_preconditioner(lo, lam_max, order=order)
    return m, order, lo, lam_max


def poisson_matrix(nsize: int, dtype=torch.float64,
                   device="cuda") -> torch.Tensor:
    """Dense N²×N² 5-point Laplacian, A = I⊗K + K⊗I with K = tridiag(−1, 2, −1),
    built on ``device`` (the card unless the caller asks for the CPU)."""
    eye = torch.eye(nsize, dtype=dtype, device=device)
    k = (2.0 * eye
         - torch.diag(torch.ones(nsize - 1, dtype=dtype, device=device), 1)
         - torch.diag(torch.ones(nsize - 1, dtype=dtype, device=device), -1))
    return torch.kron(eye, k) + torch.kron(k, eye)
