"""Explicit halo-exchange distributed stencil operator.

Counterpart of ``gmres_tpu/parallel/halo.py``. The (N, N) grid is
row-partitioned over the mesh (``parallel/mesh.py``): each rank owns a
(rows_local, N) block, and the 5-point stencil needs exactly one row from
each neighbour per application. JAX's ``shard_map`` becomes
``torch.distributed.tensor.experimental.local_map``: the operators take
and return row-sharded DTensors, and run on each rank's local block. A
plain tensor is taken as this rank's block as it is.

The halo exchange is two one-row messages to each neighbouring rank
(``isend``/``irecv``). Rank 0 receives no row from above and the last rank
none from below: those halo rows are zero, which IS the homogeneous
Dirichlet truncation of the reference, so physical boundaries need no
special case. A one-rank mesh sends nothing. ``halo_exchange`` returns the
two rows, as JAX's does; the operators take them from ``_halo_rows``,
which gives None for a side without a neighbour, and the kernels read a
null row as zero: an application on one rank is one launch, with no zero
rows to allocate and fill.

Each operator exchanges the halo rows, then runs the block through a
function that routes by device: ``stencil_5pt_pallas_halo`` (K1 on a CUDA
block) for the operator, ``cheb2_apply`` (K5, with cbpr2's scalars rounded
once when the preconditioner is built) for the order-2 preconditioner,
each the plain PyTorch version on a CPU block. JAX's
interior-first overlap of the exchange (``_local_stencil_overlapped``) is
not ported: on the CPU it only orders the rounding of the boundary rows
differently, and on the card it waits for multi-card runs that can measure
it. The JAX ``use_pallas``/``interpret`` switches have no counterpart: the
device decides, as everywhere in the port.

The RDMA operators (``rdma_stencil_operator``,
``rdma_chebyshev_preconditioner``) take the same blocks through
``ops/stencil_rdma.py`` (kernel K8): the halo messages are posted first, the
interior is computed while they travel, and the boundary rows that have a
neighbour are corrected after the wait, in the order of the TPU kernel's
in-kernel remote copies. They find the neighbours once and round their
coefficients once per dtype; on one rank an application is one launch.

Transposes and tangents. ``torch.func.vjp`` (which QMR, LSQR and LSMR
use for Aᵀ) and ``torch.func.jvp`` cannot trace a halo exchange: its
sends are collectives, and DTensor has no rule for them. The halo
operator therefore routes a tracked input through ``HaloStencil``, an
autograd.Function whose forward is the untracked application. The
cotangent of a stencil with halo exchange is a halo exchange of the
cotangent followed by the stencil with west↔east and south↔north swapped
(the transpose of a zero-halo 5-point stencil over the whole grid, cut
into the same row blocks); the tangent is the operator itself. Each rule
is one exchange and one K1 launch on the card, and the exchange runs
inside the Function, outside any traced graph. Forward-mode AD makes no
dual of a DTensor (``aten._has_same_storage_numel`` has no sharding rule),
so ``torch.func.jvp`` takes each rank's block, a plain tensor, where the
tangent rule applies; ``torch.func.vjp`` takes the DTensor.

``halo_exchange.exchanges`` counts the exchanges of the halo route (the
operators, cbpr2 and the sharded levels of the distributed multigrid
cycles; not the RDMA route), one per application on every rank.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from gmres_tpu_torch.ops._cuda import tracked_by
from gmres_tpu_torch.ops.fused import (
    cheb2_apply,
    cheb2_scalars,
    chebyshev_ref_scalars,
)
from gmres_tpu_torch.ops.stencil import stencil_5pt_pallas_halo
from gmres_tpu_torch.ops.stencil_rdma import (
    _coefs7,
    _neighbours,
    post_halo_rows,
    rdma_apply,
)
from gmres_tpu_torch.parallel.mesh import GRID_AXIS

LAPLACE_COEFS = (4.0, -1.0, -1.0, -1.0, -1.0)


def _halo_rows(blk: torch.Tensor, group, neighbours):
    """(top, bottom) halo rows of ``blk`` from the ``neighbours`` of
    ``_neighbours(group)``, each (1, ncols), None for a side with no
    neighbour (no row is allocated for it)."""
    top, bottom, wait = post_halo_rows(blk, group, neighbours)
    wait()
    halo_exchange.exchanges += 1
    return top, bottom


def halo_exchange(blk: torch.Tensor, group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exchange one-row halos with the neighbouring ranks of ``group`` (a
    process group, such as ``mesh.get_group("grid")``; None is the default
    group).

    Returns (top, bottom), each (1, ncols): ``top`` is the neighbour row
    above this block (zeros on rank 0), ``bottom`` the row below (zeros on
    the last rank)."""
    top, bottom = _halo_rows(blk, group, _neighbours(group))

    def row(h):
        return torch.zeros((1, blk.shape[1]), dtype=blk.dtype,
                           device=blk.device) if h is None else h

    return row(top), row(bottom)


# Halo exchanges of the halo route since the count was last set to 0.
halo_exchange.exchanges = 0


def halo_apply_local(blk: torch.Tensor, coefs, group, neighbours) -> torch.Tensor:
    """One application of the 5-point stencil ``coefs`` to this rank's
    block: one halo exchange over ``group`` with the ``neighbours`` of
    ``_neighbours(group)``, then K1's halo form on a CUDA block (its plain
    version on a CPU block)."""
    top, bottom = _halo_rows(blk, group, neighbours)
    return stencil_5pt_pallas_halo(blk, top, bottom, coefs)


def _sharded(mesh, fn: Callable) -> Callable:
    """``fn`` on each rank's block of a row-sharded DTensor (local_map)."""
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor.experimental import local_map

    return local_map(fn, out_placements=[Shard(0)], in_placements=([Shard(0)],),
                     device_mesh=mesh)


class HaloStencil(torch.autograd.Function):
    """The halo operator ``op`` (a ``HaloOperator``) applied to x, with a
    transpose and a tangent rule: ``HaloStencil.apply(x, op)``.

    * backward: Aᵀ is the mirrored operator (west↔east, south↔north): x's
      cotangent is ``op.mirror`` applied to the cotangent, one exchange of
      the cotangent's boundary rows and one stencil;
    * jvp: the operator is linear, so x's tangent maps through ``op``.

    Both rules apply this Function again, so they stay differentiable. The
    forward runs on untracked tensors (torch.func hands it unwrapped ones),
    so the exchange and the launch never enter a traced graph.
    ``rule_applications`` counts the rules' applications."""

    @staticmethod
    def forward(x, op):
        return op.untracked(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.op = inputs[1]

    @staticmethod
    def backward(ctx, gy):
        HaloStencil.rule_applications["transpose"] += 1
        return HaloStencil.apply(gy, ctx.op.mirror), None

    @staticmethod
    def jvp(ctx, gx, _):
        HaloStencil.rule_applications["tangent"] += 1
        return HaloStencil.apply(gx, ctx.op)


HaloStencil.rule_applications = {"transpose": 0, "tangent": 0}


class HaloOperator:
    """Matrix-free 5-point stencil ``coefs`` over a row-partitioned grid with
    explicit halo exchange (see :func:`halo_stencil_operator`). Called on a
    row-sharded DTensor it returns one; on a plain tensor, this rank's
    block. ``mirror`` is its transpose (the stencil with west↔east and
    south↔north swapped)."""

    def __init__(self, mesh, coefs, axis: str = GRID_AXIS):
        self.mesh, self.axis = mesh, axis
        self.coefs = tuple(float(c) for c in coefs)
        self.group = mesh.get_group(axis)
        self.neighbours = _neighbours(self.group)
        self.untracked = _sharded(mesh, self.apply_local)
        self._mirror = None

    def apply_local(self, blk: torch.Tensor) -> torch.Tensor:
        """The operator on this rank's block (one exchange, one stencil)."""
        return halo_apply_local(blk, self.coefs, self.group, self.neighbours)

    @property
    def mirror(self) -> "HaloOperator":
        if self._mirror is None:
            c, w, e, s, n = self.coefs
            self._mirror = HaloOperator(self.mesh, (c, e, w, n, s), self.axis)
            self._mirror._mirror = self
        return self._mirror

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if tracked_by(x) is None:
            return self.untracked(x)
        return HaloStencil.apply(x, self)


def halo_stencil_operator(
    mesh,
    coefs=LAPLACE_COEFS,
    axis: str = GRID_AXIS,
) -> HaloOperator:
    """Matrix-free 5-point stencil over a row-partitioned (N, N) grid with
    explicit halo exchange: K1 on a CUDA block, its plain version on a CPU
    block.

    The returned callable has the standard LinearOperator contract and
    composes with the solvers, which never know the operator is
    distributed. Autograd and ``torch.func`` differentiate it through
    ``HaloStencil``'s rules (QMR, LSQR and LSMR derive Aᵀ so)."""
    return HaloOperator(mesh, coefs, axis)


def _rdma_local(coefs7, group) -> Callable:
    """The RDMA route's per-block application of ``coefs7`` over ``group``:
    the neighbours found once, the coefficients rounded once per dtype when
    first applied."""
    neighbours = _neighbours(group)
    rounded = {}

    def apply_local(blk):
        c = rounded.get(blk.dtype)
        if c is None:
            c = rounded[blk.dtype] = _coefs7(coefs7, blk.dtype)
        return rdma_apply(blk, c, group, neighbours)

    return apply_local


def rdma_stencil_operator(
    mesh,
    coefs=LAPLACE_COEFS,
    axis: str = GRID_AXIS,
) -> Callable:
    """Matrix-free 5-point stencil over a row-partitioned grid on the RDMA
    route (``ops/stencil_rdma.py``): the halo messages are posted first and
    overlap the interior, and only the two boundary rows wait for them. The
    same LinearOperator contract and boundary semantics as
    :func:`halo_stencil_operator`; K8 on a CUDA block, its plain version on
    a CPU block, in float32 or float64."""
    return _sharded(mesh, _rdma_local((*(float(c) for c in coefs), 0.0, 1.0),
                                      mesh.get_group(axis)))


def rdma_chebyshev_preconditioner(
    mesh,
    lam_min: float,
    lam_max: float,
    coefs=LAPLACE_COEFS,
    axis: str = GRID_AXIS,
) -> Callable:
    """Degree-2 Chebyshev preconditioner (cbpr2) as one RDMA-route stencil
    application: by linearity z = r/d + α(r − A(r)/d) = (1/d + α)·r −
    (α/d)·A(r), the affine form of ``stencil_5pt_rdma`` with
    (a, b) = (1/d + α, −α/d), computed in Python floats and rounded to the
    block's dtype as gmres_tpu rounds them (not K5's host-rounded 1/d)."""
    d, alpha = chebyshev_ref_scalars(lam_min, lam_max)
    coefs7 = (*(float(c) for c in coefs), 1.0 / d + alpha, -alpha / d)
    return _sharded(mesh, _rdma_local(coefs7, mesh.get_group(axis)))


def halo_poisson_operator(mesh) -> Callable:
    """Distributed Laplacian (the reference Poisson operator's semantics)."""
    return halo_stencil_operator(mesh, LAPLACE_COEFS)


def halo_chebyshev_preconditioner(
    mesh,
    lam_min: float,
    lam_max: float,
    coefs=LAPLACE_COEFS,
    axis: str = GRID_AXIS,
    order: int = 2,
) -> Callable:
    """Distributed Chebyshev preconditioner over the halo operator.

    order=2 (default) is cbpr2 fused: one halo exchange and one pass
    producing z = r·(1/d) + α(r − A(r)·(1/d)): K5 on a CUDA block, its
    plain version on a CPU block, with the scalars rounded to the block's
    dtype when the preconditioner is built. order>2 composes the general
    semi-iteration over the halo stencil operator (one halo exchange per
    sweep)."""
    from gmres_tpu_torch.precond.chebyshev import chebyshev_preconditioner

    if order != 2:
        a_halo = halo_stencil_operator(mesh, coefs, axis=axis)
        return chebyshev_preconditioner(
            a_halo, lam_min, lam_max, order=order, reference_form=False
        )

    d, alpha = chebyshev_ref_scalars(lam_min, lam_max)
    group = mesh.get_group(axis)
    neighbours = _neighbours(group)
    # [1/d, α, c0…cn] rounded once per dtype, not per application.
    scal = {dt: cheb2_scalars(d, alpha, coefs, dt)
            for dt in (torch.float32, torch.float64)}

    def m_inv_local(r_blk):
        top, bottom = _halo_rows(r_blk, group, neighbours)
        s = scal.get(r_blk.dtype) or cheb2_scalars(d, alpha, coefs, r_blk.dtype)
        return cheb2_apply(r_blk, top, bottom, s)

    return _sharded(mesh, m_inv_local)
