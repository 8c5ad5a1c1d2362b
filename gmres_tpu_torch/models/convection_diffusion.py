"""2-D convection-diffusion model problem (nonsymmetric): BASELINE config 3.

Counterpart of ``gmres_tpu/models/convection_diffusion.py``. −Δu + (bx, by)·∇u
with central differences on a uniform grid, scaled like the Poisson stencil
(centre 4):

    y(i,j) = 4·x(i,j) − (1+γy)·x(i−1,j) − (1−γy)·x(i+1,j)
                      − (1+γx)·x(i,j−1) − (1−γx)·x(i,j+1)

with cell-Péclet numbers γ = b·h/2; γ = 0 is the Poisson stencil. The
coefficient functions return the JAX module's Python floats. The operator
routes by device like ``models/poisson.py``: a CUDA tensor launches kernel
K1 with the general coefficients, a CPU tensor takes the plain
``stencil_5pt_general`` (the JAX operator is that plain stencil).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from gmres_tpu_torch.ops.blas import row_blocks
from gmres_tpu_torch.ops.stencil import stencil_5pt_routed_general


def convection_diffusion_coefs(gamma_x: float, gamma_y: float):
    """(center, west, east, south, north) stencil coefficients."""
    return (
        4.0,
        -(1.0 + gamma_x),
        -(1.0 - gamma_x),
        -(1.0 + gamma_y),
        -(1.0 - gamma_y),
    )


def convection_diffusion_coefs_upwind(gamma_x: float, gamma_y: float):
    """(center, west, east, south, north) of the first-order upwind
    discretisation of the same operator: an M-matrix at any cell-Péclet
    number, the multigrid cycle's coarse-level rediscretisation."""
    gx, gy = float(gamma_x), float(gamma_y)
    return (
        4.0 + 2.0 * abs(gx) + 2.0 * abs(gy),
        -(1.0 + 2.0 * max(gx, 0.0)),
        -(1.0 + 2.0 * max(-gx, 0.0)),
        -(1.0 + 2.0 * max(gy, 0.0)),
        -(1.0 + 2.0 * max(-gy, 0.0)),
    )


def convection_diffusion_apply(
    x: torch.Tensor, gamma_x: float = 0.4, gamma_y: float = 0.2
) -> torch.Tensor:
    """y = A·x on an (N, N) grid (or flat (N²,))."""
    c = convection_diffusion_coefs(gamma_x, gamma_y)
    if x.dim() == 1:
        n = int(round(x.shape[0] ** 0.5))
        return stencil_5pt_routed_general(x.reshape(n, n), c).reshape(-1)
    return stencil_5pt_routed_general(x, c)


def convection_diffusion_operator(
    nsize: int, gamma_x: float = 0.4, gamma_y: float = 0.2
) -> Callable:
    """The matrix-free operator closure on (nsize, nsize) grids."""
    c = convection_diffusion_coefs(gamma_x, gamma_y)

    def apply_grid(x: torch.Tensor) -> torch.Tensor:
        return stencil_5pt_routed_general(x, c)

    return row_blocks(apply_grid)


def convection_diffusion_matrix(
    nsize: int, gamma_x: float = 0.4, gamma_y: float = 0.2,
    dtype=torch.float64, device="cuda",
) -> torch.Tensor:
    """Dense assembly for small-n validation (C-order flattening), built on
    ``device`` (the card unless the caller asks for the CPU)."""
    c0, cw, ce, cs, cn = convection_diffusion_coefs(gamma_x, gamma_y)

    def eye(k=0):
        return torch.diag(torch.ones(nsize - abs(k), dtype=dtype, device=device), k)

    kx = c0 / 2.0 * eye() + cw * eye(-1) + ce * eye(1)
    ky = c0 / 2.0 * eye() + cs * eye(-1) + cn * eye(1)
    return torch.kron(eye(), kx) + torch.kron(ky, eye())


def convection_diffusion_eigenvalues(
    nsize: int, gamma_x: float = 0.4, gamma_y: float = 0.2
):
    """Closed-form spectrum (numpy, host side) of the central-difference
    operator, an (n²,) complex array:
    λ(i, j) = 4 − 2√(1−γx²)·cos(iπh) − 2√(1−γy²)·cos(jπh), h = 1/(n+1);
    complex for |γ| > 1."""
    h = np.pi / (nsize + 1)
    sx = np.emath.sqrt(1.0 - gamma_x * gamma_x)
    sy = np.emath.sqrt(1.0 - gamma_y * gamma_y)
    i = np.arange(1, nsize + 1)
    lx = 2.0 - 2.0 * sx * np.cos(i * h)
    ly = 2.0 - 2.0 * sy * np.cos(i * h)
    return (lx[:, None] + ly[None, :]).ravel()
