"""Variable-coefficient diffusion −∇·(c(x)∇u) on the unit square.

Counterpart of ``gmres_tpu/models/varcoef.py``: the finite-volume
discretisation with harmonic-mean face coefficients, h²-scaled,

    (A u)ᵢⱼ = Σ_faces c_face (uᵢⱼ − u_nbr),   c_face = 2 c₁c₂/(c₁+c₂),

with a Dirichlet ghost coefficient equal to the cell's own c. The
coefficients vary over the grid, so no kernel of the port serves this
operator: it and its multigrid cycle are plain PyTorch on the tensors'
device, as the JAX module is plain jnp, with the JAX module's operations
in its order.

The coefficient field c is a tensor (``as_tensor(c, device)`` carries a
numpy field over); its device is the device of everything built from it.

On a row-sharded DTensor x the operator (and the cycle's level operators)
take the DTensor route of ``parallel/halo.py:sharded_apply``: the four face
fields, computed on the whole c that every rank holds, are cut to the
rank's rows once per mesh (no message) and kept in the operator's closure
beside the fields they come from, and an application is one exchange of
x's boundary rows and ``_faces_halo`` on the block with them. A face of a rank's first or last row couples to the neighbour's
cell, so it is the whole grid's face (the harmonic mean with the
neighbour's c), never the Dirichlet edge copy. The cycle's Jacobi weights
are placed as r is (``ops/blas.py:place_like``); its restrictions on a
sharded level are DTensor's own (two all-gathers, the level after them
replicated, where the level operators take the plain route on the local
tensor). gmres_tpu gives this cycle no ``mesh=`` form, and the port keeps
it so on either device: no kernel wrapper sees a DTensor, since the
sharded level's stencil is the halo route and the replicated levels' is
the local tensor's.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from gmres_tpu_torch.ops.blas import place_like, row_blocks
from gmres_tpu_torch.ops.stencil import on_sharded_grid, prolong_repeat, restrict_sum
from gmres_tpu_torch.parallel.halo import HaloForm, sharded_apply


def _field(c) -> torch.Tensor:
    if not isinstance(c, torch.Tensor):
        raise TypeError("c must be a tensor on the device to solve on "
                        f"(gmres_tpu_torch.as_tensor(c, device)), got {type(c)}")
    return c


def _edge_pad(c: torch.Tensor, dim: int) -> torch.Tensor:
    """c with its first and last row (dim 0) or column (dim 1) repeated."""
    first, last = c.narrow(dim, 0, 1), c.narrow(dim, c.shape[dim] - 1, 1)
    return torch.cat([first, c, last], dim=dim)


def varcoef_faces(
    c: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Harmonic-mean face couplings (cn, cs, cw, ce) from (n, n) cell
    coefficients; each (n, n), coupling cell (i, j) to its north, south,
    west and east neighbour (Dirichlet ghost = own c)."""
    c = _field(c)

    def harm(a, b):
        return 2.0 * a * b / (a + b)

    cpx = _edge_pad(c, 0)
    cpy = _edge_pad(c, 1)
    cn = harm(cpx[:-2, :], c)
    cs = harm(cpx[2:, :], c)
    cw = harm(cpy[:, :-2], c)
    ce = harm(cpy[:, 2:], c)
    return cn, cs, cw, ce


def _faces_operator(faces) -> Callable:
    """The operator with face fields ``faces``: the whole-grid form on a
    plain grid; on a DTensor x the DTensor route (module docstring), the
    fields cut to the rank's rows once per mesh and kept in this closure."""
    forms = {}

    def make(mesh):
        rows = faces[0].shape[0] // mesh.size()
        own = [f.narrow(0, mesh.get_coordinate()[0] * rows, rows).contiguous()
               for f in faces]
        return HaloForm(mesh, lambda blk, top, bottom: _faces_halo(own, blk, top, bottom),
                        0, 0)

    def apply(x: torch.Tensor) -> torch.Tensor:
        if on_sharded_grid(x):
            return sharded_apply(x, forms, make, apply)
        return _faces_halo(faces, x)

    return row_blocks(apply)


def _faces_halo(faces, x: torch.Tensor, top=None, bottom=None) -> torch.Tensor:
    """The operator's form on a block of rows x, ``top``/``bottom`` the rows
    above and below it (None: the zero Dirichlet row; both None: the whole
    grid)."""
    cn, cs, cw, ce = faces
    if top is None and bottom is None:
        xp = F.pad(x, (1, 1, 1, 1))
    else:
        def row(h):
            return torch.zeros_like(x[:1]) if h is None else h.reshape(1, -1)

        xp = F.pad(torch.cat([row(top), x, row(bottom)]), (1, 1))
    return (cn * (x - xp[:-2, 1:-1]) + cs * (x - xp[2:, 1:-1])
            + cw * (x - xp[1:-1, :-2]) + ce * (x - xp[1:-1, 2:]))


def varcoef_apply(c: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """One application of the variable-coefficient 5-point operator."""
    return _faces_operator(varcoef_faces(c))(x)


def varcoef_operator(c: torch.Tensor) -> Callable:
    """Matrix-free operator closure; the face coefficients are computed
    once."""
    return _faces_operator(varcoef_faces(c))


def varcoef_diagonal(c: torch.Tensor) -> torch.Tensor:
    """The operator's diagonal cn+cs+cw+ce, the Jacobi scaling (4 at
    c ≡ 1)."""
    cn, cs, cw, ce = varcoef_faces(c)
    return cn + cs + cw + ce


def varcoef_matrix(c: torch.Tensor, dtype=torch.float64) -> torch.Tensor:
    """Dense assembly (C-order flattening) for small-n oracles, on c's
    device; symmetric by construction of the faces."""
    cn, cs, cw, ce = (f.detach().cpu().numpy().astype(np.float64)
                      for f in varcoef_faces(c))
    n = cn.shape[0]
    N = n * n
    a = np.zeros((N, N))
    a[np.arange(N), np.arange(N)] = (cn + cs + cw + ce).ravel()
    idx = np.arange(N).reshape(n, n)
    a[idx[1:, :].ravel(), idx[:-1, :].ravel()] = -cn[1:, :].ravel()
    a[idx[:-1, :].ravel(), idx[1:, :].ravel()] = -cs[:-1, :].ravel()
    a[idx[:, 1:].ravel(), idx[:, :-1].ravel()] = -cw[:, 1:].ravel()
    a[idx[:, :-1].ravel(), idx[:, 1:].ravel()] = -ce[:, :-1].ravel()
    return torch.as_tensor(a, dtype=dtype, device=c.device)


def varcoef_multigrid_preconditioner(
    c: torch.Tensor,
    pre_smooth: int = 3,
    post_smooth: int = 3,
    omega: float = 0.8,
    coarse_iters: int = 64,
    min_size: int = 16,
    max_levels: int | None = None,
) -> Callable:
    """V-cycle preconditioner with per-level rediscretised coefficients
    (2×2 cell averages, restrict_sum(c)/4) and pointwise damped-Jacobi
    smoothing e ← e + ω D⁻¹ (r − A e) with the spatially varying diagonal
    D (the arguments of the JAX function). SPD at every level, hence a
    legal CG preconditioner. Levels coarsen while the grid is even and
    above ``min_size`` rows (at most ``max_levels``); the coarsest level
    runs ``coarse_iters`` Jacobi steps."""
    levels_c = [_field(c)]
    n = c.shape[0]
    while n % 2 == 0 and n > min_size and (
        max_levels is None or len(levels_c) < max_levels
    ):
        levels_c.append(restrict_sum(levels_c[-1]) / 4.0)
        n //= 2
    faces = [varcoef_faces(cl) for cl in levels_c]
    ops = [_faces_operator(f) for f in faces]
    winv = [omega / (f[0] + f[1] + f[2] + f[3]) for f in faces]
    n_levels = len(levels_c)

    def smooth(r, l, iters):
        w = place_like(winv[l], r)
        e = torch.zeros_like(r)
        for _ in range(iters):
            e = e + w * (r - ops[l](e))
        return e

    def v_cycle(r, l):
        if l == n_levels - 1:
            return smooth(r, l, coarse_iters)
        e = smooth(r, l, pre_smooth)
        resid = r - ops[l](e)
        e = e + prolong_repeat(v_cycle(restrict_sum(resid), l + 1))
        resid = r - ops[l](e)
        return e + smooth(resid, l, post_smooth)

    def m_inv(r: torch.Tensor) -> torch.Tensor:
        return v_cycle(r, 0)

    return m_inv
