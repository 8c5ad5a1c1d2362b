"""2-D Helmholtz model problem (symmetric indefinite).

Counterpart of ``gmres_tpu/models/helmholtz.py``: −Δu − k²u with the unit
5-point stencil, h² folded out like the Poisson stencil (centre 4),

    y(i,j) = (4 − (kh)²)·x(i,j) − x(i±1,j) − x(i,j±1),

symmetric for every k and indefinite once (kh)² exceeds the smallest
Laplacian eigenvalue 8·sin²(π/(2(n+1))) — MINRES's regime. ``damping`` > 0
makes the centre −(1 + i·damping)·kh2 complex (an absorbing medium).

Routing: the real operator (damping 0) is K1 with (4 − kh2, −1, −1, −1, −1)
on a CUDA tensor and the plain stencil on a CPU tensor, like the Poisson
operator. K1 is real-only, so the damped (complex) operator is the plain
stencil on any device, as the CSL cycle is. ``helmholtz_split_operator``
carries the complex field as a real (2, N, N) stack: two real Laplacians
(K1 on the card) and the 2×2 rotation of the centre term in torch.

On a row-sharded DTensor each operator takes the DTensor route
(``parallel/halo.py``): the real one K1's halo form, the complex one the
plain complex halo form, and the split operator on a ``[Shard(1)]`` stack
(``P(None, "grid", None)`` in gmres_tpu) one exchange of both planes' rows
and two K1 halo-form launches; on a block of s stacks placed ``[Shard(2)]``
(``ops/blas.py:row_apply``) one exchange of the s stacks' rows and two
launches of K1's halo form on lanes, one a plane, each lane the s stacks'
plane. The operators are marked as taking such a block whole
(``ops/blas.py:row_blocks``).
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from gmres_tpu_torch.ops.stencil import (
    POISSON_COEFS,
    on_sharded_grid,
    stencil_5pt_general,
    stencil_5pt_pallas_halo,
    stencil_5pt_routed_general,
)
from gmres_tpu_torch.ops.blas import row_blocks
from gmres_tpu_torch.parallel.halo import HaloForm, sharded_apply


def helmholtz_coefs(kh2: float, damping: float = 0.0):
    """(center, west, east, south, north) stencil coefficients for
    −Δ − (1 + i·damping)·k² at kh2 = (k·h)²: real floats, or a complex
    centre when damping > 0."""
    if damping:
        return (
            4.0 - float(kh2) * complex(1.0, float(damping)),
            -1.0, -1.0, -1.0, -1.0,
        )
    return (4.0 - float(kh2), -1.0, -1.0, -1.0, -1.0)


def helmholtz_lambda_min(nsize: int, kh2: float = 0.0) -> float:
    """Exact smallest eigenvalue of the (shifted) stencil on the
    nsize×nsize Dirichlet grid: 8·sin²(π/(2(n+1))) − kh2; negative ⇔
    indefinite."""
    return 8.0 * math.sin(math.pi / (2 * (nsize + 1))) ** 2 - float(kh2)


def _apply(x: torch.Tensor, c) -> torch.Tensor:
    """The stencil with coefficients c: K1's route where c and x are real,
    the plain stencil (any device) where either is complex."""
    if isinstance(c[0], complex) or x.is_complex():
        return stencil_5pt_general(x, *c)
    return stencil_5pt_routed_general(x, c)


def helmholtz_apply(x: torch.Tensor, kh2: float = 0.5,
                    damping: float = 0.0) -> torch.Tensor:
    """y = A·x on an (N, N) grid (or flat (N²,))."""
    c = helmholtz_coefs(kh2, damping)
    if x.dim() == 1:
        n = int(round(x.shape[0] ** 0.5))
        return _apply(x.reshape(n, n), c).reshape(-1)
    return _apply(x, c)


def helmholtz_operator(nsize: int, kh2: float = 0.5,
                       damping: float = 0.0) -> Callable:
    """The matrix-free operator closure on (nsize, nsize) grids."""
    c = helmholtz_coefs(kh2, damping)

    def apply_grid(x: torch.Tensor) -> torch.Tensor:
        return _apply(x, c)

    return row_blocks(apply_grid)


def helmholtz_matrix(nsize: int, kh2: float = 0.5, dtype=torch.float64,
                     damping: float = 0.0, device="cuda") -> torch.Tensor:
    """Dense assembly for small-n validation (C-order flattening), built on
    ``device`` (the card unless the caller asks for the CPU); complex128
    when damping > 0 and ``dtype`` is real."""
    if damping and not dtype.is_complex:
        dtype = torch.complex128
    c0, cw, ce, cs, cn = helmholtz_coefs(kh2, damping)

    def eye(k=0):
        return torch.diag(torch.ones(nsize - abs(k), dtype=dtype, device=device), k)

    kx = c0 / 2.0 * eye() + cw * eye(-1) + ce * eye(1)
    ky = c0 / 2.0 * eye() + cs * eye(-1) + cn * eye(1)
    return torch.kron(eye(), kx) + torch.kron(ky, eye())


def helmholtz_split_operator(nsize: int, kh2: float = 0.5,
                             damping: float = 0.0) -> Callable:
    """The complex operator on the real (2, N, N) stack u = [uʳ; uⁱ]:
    (A + iB)(uʳ + i·uⁱ) = b ⇔ [A −B; B A][uʳ; uⁱ] = [bʳ; bⁱ], two real
    Laplacians (K1 on the card) plus the rotation of the centre term. The
    stack is an ordinary real vector to every solver (its 2-norm is the
    complex field's). A ``[Shard(1)]`` DTensor stack takes one exchange of
    both planes' rows and K1's halo form on each plane; a (s, 2, N, N)
    block of stacks placed ``[Shard(2)]`` takes one exchange and K1's halo
    form once a plane on the s stacks' planes as lanes."""
    kh2 = float(kh2)
    alpha = float(damping)

    def rotate(u, lap_r, lap_i):
        # A stack (2, rows, N) or a block of stacks (s, 2, rows, N).
        ur, ui = u[..., 0, :, :], u[..., 1, :, :]
        # −(1 + iα)·kh2·u: re −kh2·(ur − α·ui), im −kh2·(α·ur + ui)
        out_r = lap_r - kh2 * (ur - alpha * ui)
        out_i = lap_i - kh2 * (alpha * ur + ui)
        return torch.stack([out_r, out_i], dim=-3)

    def local(u, top, bottom):
        return rotate(u, *split_laplacians(u, top, bottom, POISSON_COEFS))

    forms = {}

    def apply_pair(u: torch.Tensor) -> torch.Tensor:
        if on_sharded_grid(u):
            return sharded_apply(u, forms,
                                 lambda mesh: HaloForm(mesh, local, 1, 0, lanes=True),
                                 apply_pair, dim=1)
        return rotate(u, stencil_5pt_routed_general(u[0], POISSON_COEFS),
                      stencil_5pt_routed_general(u[1], POISSON_COEFS))

    return row_blocks(apply_pair)


def split_laplacians(u: torch.Tensor, top, bottom, coefs):
    """The 5-point stencil ``coefs`` on both planes of a (2, rows, N) block
    of a split stack, ``top``/``bottom`` its (2, 1, N) halo rows (None: zero
    rows): two launches of K1's halo form on a CUDA block, its plain version
    on a CPU one. A (s, 2, rows, N) block of s stacks with (s, 2, 1, N) halo
    rows: the same two launches, each on the s stacks' plane as lanes
    (made contiguous), each lane the bits of its own stack's."""
    def plane(t, k):
        return None if t is None else t[..., k, :, :].contiguous()

    return tuple(stencil_5pt_pallas_halo(plane(u, k), plane(top, k), plane(bottom, k),
                                         coefs)
                 for k in (0, 1))


def complex_to_split(x: torch.Tensor) -> torch.Tensor:
    """(N, N) complex → (2, N, N) real stack."""
    return torch.stack([x.real, x.imag])


def split_to_complex(u: torch.Tensor) -> torch.Tensor:
    """(2, N, N) real stack → (N, N) complex."""
    return u[0] + 1j * u[1]
