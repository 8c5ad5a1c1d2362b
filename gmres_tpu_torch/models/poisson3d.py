"""3-D Poisson model problem (7-point stencil).

Counterpart of ``gmres_tpu/models/poisson3d.py``: A = h²(−Δ) on an
(N, N, N) grid with homogeneous Dirichlet boundaries, centre 6 and unit
off-diagonals. The operator is ``ops/stencil.py:stencil_7pt_apply``, plain
PyTorch on any device (the JAX operator is plain jnp; neither package has a
3-D kernel).
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from gmres_tpu_torch.ops.blas import row_blocks
from gmres_tpu_torch.ops.stencil import stencil_7pt_apply


def poisson3d_operator(nsize: int) -> Callable:
    """y = A·x on an (N, N, N) grid (nsize is kept for the JAX signature;
    the shape travels with x)."""
    del nsize
    return stencil_7pt_apply


@row_blocks
def poisson3d_apply(x: torch.Tensor) -> torch.Tensor:
    return stencil_7pt_apply(x)


def poisson3d_matrix(nsize: int, dtype=torch.float64, device="cuda") -> torch.Tensor:
    """Dense N³×N³ assembly for small-n validation (C-order flattening of
    (i, j, k) with k fastest), built on ``device`` (the card unless the
    caller asks for the CPU)."""
    eye = torch.eye(nsize, dtype=dtype, device=device)
    t = (2.0 * eye
         - torch.diag(torch.ones(nsize - 1, dtype=dtype, device=device), -1)
         - torch.diag(torch.ones(nsize - 1, dtype=dtype, device=device), 1))
    return (torch.kron(torch.kron(t, eye), eye)
            + torch.kron(torch.kron(eye, t), eye)
            + torch.kron(torch.kron(eye, eye), t))


def poisson3d_spectral_bounds(nsize: int) -> tuple:
    """Exact extreme eigenvalues of the unit 7-point stencil on the
    Dirichlet (n, n, n) grid: 6 ∓ 6·cos(π/(n+1))."""
    c = math.cos(math.pi / (nsize + 1))
    return 6.0 * (1.0 - c), 6.0 * (1.0 + c)
