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

The halo forms. ``HaloForm`` runs a local form ``local(blk, top,
bottom)`` on each rank's block of a grid sharded along one dimension of a
1-D mesh, after one exchange of the block's first and last slices along it
(``_halo_rows``): rows of a 2-D grid, planes of a 3-D grid, or the rows of
both planes of a (2, rows, N) split-complex stack in one message each way;
any dtype, complex included. ``HaloOperator`` is the real 5-point form
(K1's halo form on the card) with its transpose and tangent rules; the
other forms are plain torch on any device, as gmres_tpu's are plain jnp:
the complex 5-point stencil (``ops/stencil.py:stencil_5pt_halo``), the
7-point stencil (``stencil_7pt_halo``), the split stack and the
variable-coefficient faces (``models/``). They have no rules, and a
tracked input raises.

The DTensor route (ROADMAP queue 1, item 8.5). gmres_tpu's GSPMD lowers
the jnp shifts of its plain operators on a sharded grid to halo permutes.
Here the plain stencils of ``ops/stencil.py`` and the models hand a DTensor
to ``sharded_stencil``/``sharded_apply``, which dispatch on its placement:
``[Shard(d)]`` on a 1-D mesh, on the grid dimension d and evenly, is one
``local_map`` over the matching halo form (one exchange, one local
application; the form is built once per mesh and stencil); ``[Replicate()]``
is the plain computation on the local tensor; anything else raises
NotImplementedError naming the item. No route gathers the grid. Each
operator keeps its forms in its own closure (``ops/blas.py:per_mesh``); the
plain stencils, which are functions of their coefficients, keep theirs on
the mesh under the coefficients' values (``_stencil_forms``). While
``blockwise_jvp`` runs (on this thread) a plain tensor is taken as this
rank's block of a grid row-sharded over its mesh and takes the same forms:
Newton–Krylov's J·v runs ``torch.func.jvp`` on each rank's block so.
Inside that mode only tensors shaped like the rank's block may be
stenciled; ``sharded_apply`` raises on any other.

The block form (what gmres_tpu's ``jax.vmap`` makes of a shard_map'd halo
operator). ``ops/blas.py:row_apply`` applies an operator to a (s, N, N)
block of s grids, a DTensor placed ``[Shard(1)]``, as ``torch.func.vmap``
over the rows; every operator here (``BlockSharded``: the halo operator,
every halo form, cbpr2, the RDMA operators, and the plain stencils through
``sharded_apply``) takes the vmapped DTensor whole: one ``local_map`` over
the block, sharded along its grid rows, one exchange of the s rows'
boundary slices in each direction (``_halo_rows`` along the rows dimension
of the (s, rows, N) local block) and one application of the form to the
rank's (s, rows, N) block with (s, 1, N) halo rows, each row the bits of its
own call: K1's halo form, K5 and K8 each take the lanes in one launch on the
card; the plain forms map over the rows with ``torch.func.vmap``. The
Chebyshev semi-iteration of order > 2 is elementwise vector work between
applications of the halo operator, so vmap carries it. These operators are
marked as taking the block whole (``ops/blas.py:row_blocks``), and
row_apply decides by the mark before it calls one. The distributed V-cycle
(``precond/multigrid.py:_distributed_cycle``) and the sparse operators'
rank rows (``ops/sparse.py:_RankRows``) are ``BlockSharded`` too. A block
that autograd or another transform tracks, and an operator that is not
marked, goes one row at a time.

``halo_exchange.exchanges`` counts the exchanges of the halo route (the
operators, every halo form, cbpr2 and the sharded levels of the distributed
multigrid cycles) and of the RDMA operators, one per application on every
rank, an application to a block of rows included.
"""

from __future__ import annotations

import threading
from typing import Callable, Tuple

import torch

from gmres_tpu_torch.ops import _cuda
from gmres_tpu_torch.ops._cuda import tracked_by
from gmres_tpu_torch.ops.blas import dtensor_of, is_dtensor, per_mesh, refuse_row_block
from gmres_tpu_torch.ops.fused import (
    cheb2_apply,
    cheb2_scalars,
    chebyshev_ref_scalars,
)
from gmres_tpu_torch.ops.stencil import (
    stencil_5pt_halo,
    stencil_5pt_pallas_halo,
    stencil_7pt_halo,
)
from gmres_tpu_torch.ops.stencil_rdma import (
    _coefs7,
    _neighbours,
    post_halo_rows,
    rdma_apply,
)
from gmres_tpu_torch.parallel.mesh import GRID_AXIS

LAPLACE_COEFS = (4.0, -1.0, -1.0, -1.0, -1.0)


def _halo_rows(blk: torch.Tensor, group, neighbours, dim: int = 0, width: int = 1):
    """(top, bottom) halo slices of ``blk`` along ``dim`` from the
    ``neighbours`` of ``_neighbours(group)``, each ``width`` along ``dim`` (a
    row, a plane, both planes' rows of a split stack, or a sparse band's
    entries of a flat vector), None for a side with no neighbour (nothing is
    allocated for it)."""
    top, bottom, wait = post_halo_rows(blk, group, neighbours, dim, width)
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
    version on a CPU block). A (s, rows, N) block of s rows' blocks (the
    block form) is one exchange of the s rows' boundary rows and one
    launch."""
    top, bottom = _halo_rows(blk, group, neighbours, blk.dim() - 2)
    return stencil_5pt_pallas_halo(blk.contiguous(), top, bottom, coefs)


def _sharded(mesh, fn: Callable, dim: int = 0) -> Callable:
    """``fn`` on each rank's block of a DTensor sharded along ``dim``
    (local_map); a plain tensor is taken as this rank's block as it is."""
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor.experimental import local_map

    return local_map(fn, out_placements=[Shard(dim)], in_placements=([Shard(dim)],),
                     device_mesh=mesh)


def _vmapped_rows(x):
    """(vmap levels, their batch sizes, batch dim, block) where
    ``torch.func.vmap`` levels (row_apply's) batch x and nothing else wraps
    or tracks it: the block is the tensor they batch, the levels' rows in
    one axis (nested levels flattened first) at the batch dim — a DTensor
    ((s, N, N) placed ``[Shard(1)]`` for a block of row-sharded grids) or a
    plain tensor (the rank's own rows). None otherwise."""
    if not _cuda.vmapped(x):
        return None
    found = _cuda._lanes_of((x,))
    if found is None:
        return None
    levels, sizes, (bdim,), (blk,) = found
    return levels, sizes, bdim, blk


class BlockSharded:
    """``local`` on each rank's block of a DTensor sharded along ``dim`` of
    a 1-D mesh (``local_map``; a plain tensor is this rank's block as it
    is), and the block form: where ``torch.func.vmap`` batches the DTensor
    (``ops/blas.py:row_apply`` over a block of rows), one ``local_map``
    over the block, sharded along ``dim + 1``, and one call of ``rows`` on
    each rank's (s, …) block of the s rows (default ``local``, which then
    takes either). The rows come back wrapped at vmap's levels. A block
    placed otherwise raises NotImplementedError. Marked as taking a block
    of rows whole (``ops/blas.py:row_blocks``).

    ``on_rows`` sets the vmap levels aside (``_cuda.below_vmap``) while it
    works on the DTensor, which rests on functorch's private dynamic layer
    stack (ROADMAP queue 2)."""

    takes_row_blocks = True

    def __init__(self, mesh, local: Callable, rows: Callable | None = None, dim: int = 0):
        self.mesh, self.dim = mesh, dim
        self.rows = local if rows is None else rows
        self.untracked = _sharded(mesh, local, dim)
        self.block = _sharded(mesh, self.rows, dim + 1)

    def on_rows(self, found) -> torch.Tensor:
        """The block form on ``_vmapped_rows``' find: on a plain block (the
        rank's own rows, as a plain tensor is the rank's block) ``rows``
        itself; on a DTensor, ``rows`` on each rank's block of it."""
        from torch.distributed.tensor import Shard

        levels, sizes, bdim, blk = found
        if not is_dtensor(blk):
            blk = blk if bdim in (None, 0) else blk.movedim(bdim, 0)
            return _cuda._rewrap(self.rows(blk.contiguous()), levels, sizes)
        with _cuda.below_vmap():
            if bdim not in (None, 0):
                blk = blk.movedim(bdim, 0)
            mesh = blk.device_mesh
            if (mesh != self.mesh or tuple(blk.placements) != (Shard(self.dim + 1),)
                    or blk.shape[self.dim + 1] % mesh.size()):
                raise NotImplementedError(
                    f"a block of shape {tuple(blk.shape)} placed {tuple(blk.placements)}: "
                    f"the block form takes [Shard({self.dim + 1})] on the operator's mesh, "
                    "evenly")
            out = self.block(blk)
        return _cuda._rewrap(out, levels, sizes)

    def batched(self, x: torch.Tensor):
        """The block form where vmap batches x (``on_rows``); None
        otherwise."""
        found = _vmapped_rows(x)
        return None if found is None else self.on_rows(found)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        out = self.batched(x)
        return self.untracked(x) if out is None else out


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


class HaloForm(BlockSharded):
    """The local form ``local(blk, top, bottom)`` on each rank's block of a
    grid sharded along ``dim`` of a 1-D mesh, after one exchange of the
    block's first and last slices along ``dim`` (``_halo_rows``). Called on
    a DTensor sharded so it returns one; on a plain tensor, this rank's
    block. On a block of rows (``row_apply``), one exchange of the rows'
    slices and the form on the rows (``apply_rows``): with ``lanes``,
    ``local`` itself takes the (s, …) block with (s, …) halo slices, each
    row the bits of its own call (the split stack's form, which launches
    K1's halo form once a plane on the card); otherwise ``local`` is mapped
    over the rows with ``torch.func.vmap``, so it must be plain torch. No
    transpose or tangent rule: a tracked input raises NotImplementedError."""

    def __init__(self, mesh, local: Callable, dim: int = 0, axis=GRID_AXIS,
                 lanes: bool = False):
        self.axis, self.local, self.lanes = axis, local, lanes
        self.group = mesh.get_group(axis)
        self.neighbours = _neighbours(self.group)
        super().__init__(mesh, self.apply_local, self.apply_rows, dim)

    def apply_local(self, blk: torch.Tensor) -> torch.Tensor:
        """The form on this rank's block (one exchange, one application)."""
        top, bottom = _halo_rows(blk, self.group, self.neighbours, self.dim)
        return self.local(blk, top, bottom)

    def apply_rows(self, blk: torch.Tensor) -> torch.Tensor:
        """The form on this rank's (s, …) block of s rows: one exchange of
        the s rows' slices, then ``local`` on the block (``lanes``) or on
        each row with its own halo slices (``torch.func.vmap``)."""
        top, bottom = _halo_rows(blk, self.group, self.neighbours, self.dim + 1)
        if self.lanes:
            return self.local(blk, top, bottom)
        halos = [h for h in (top, bottom) if h is not None]

        def one(b, *hs):
            got = iter(hs)
            return self.local(b, next(got) if top is not None else None,
                              next(got) if bottom is not None else None)

        return torch.func.vmap(one)(blk, *halos)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        out = self.batched(x)
        if out is not None:
            return out
        why = tracked_by(x)
        if why is not None:
            raise NotImplementedError(
                f"this halo form has no transpose or tangent rule, and its input "
                f"is tracked by {why}: only the real 5-point stencil "
                "(HaloOperator) differentiates on a sharded grid (ROADMAP queue 1, "
                "item 8.5)")
        return self.untracked(x)


class HaloOperator(HaloForm):
    """Matrix-free 5-point stencil ``coefs`` over a row-partitioned grid with
    explicit halo exchange (see :func:`halo_stencil_operator`). Called on a
    row-sharded DTensor it returns one; on a plain tensor, this rank's
    block. ``mirror`` is its transpose (the stencil with west↔east and
    south↔north swapped)."""

    def __init__(self, mesh, coefs, axis=GRID_AXIS):
        self.coefs = tuple(float(c) for c in coefs)
        super().__init__(mesh, None, 0, axis)
        self._mirror = None

    def apply_local(self, blk: torch.Tensor) -> torch.Tensor:
        """The operator on this rank's block, or on its (s, rows, N) block
        of s rows (one exchange, one stencil: K1's halo form on lanes)."""
        return halo_apply_local(blk, self.coefs, self.group, self.neighbours)

    apply_rows = apply_local

    @property
    def mirror(self) -> "HaloOperator":
        if self._mirror is None:
            c, w, e, s, n = self.coefs
            self._mirror = HaloOperator(self.mesh, (c, e, w, n, s), self.axis)
            self._mirror._mirror = self
        return self._mirror

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        out = self.batched(x)
        if out is not None:
            return out
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


# The mesh and block shape of the active ``blockwise_jvp`` on this thread
# (``block`` None outside it).
_blockwise = threading.local()


def blockwise_active() -> bool:
    """True while ``blockwise_jvp`` runs on this thread: the plain stencils
    of ``ops/stencil.py`` and the models then take a plain tensor as this
    rank's block of the grid and apply its halo form."""
    return getattr(_blockwise, "block", None) is not None


def sharded_apply(x: torch.Tensor, forms: dict, make: Callable,
                  plain: Callable, dim: int = 0) -> torch.Tensor:
    """The plain operator ``plain`` (a whole-grid function) on a DTensor x
    through its halo form, by x's placement:

    * ``[Shard(dim)]`` on a 1-D mesh, with the dimension divisible by the
      mesh size: the halo form ``make(mesh)`` (a ``HaloForm`` sharded along
      ``dim``), built once per mesh in ``forms``, a dict that the operator
      owns (``ops/blas.py:per_mesh``); one exchange and one local
      application;
    * ``[Replicate()]``: ``plain`` on the local tensor;
    * anything else: NotImplementedError (ROADMAP queue 1, item 8.5). No
      placement is gathered.

    Under ``row_apply``'s vmap over a block of rows (a DTensor that vmap
    batches), the form's block form (``BlockSharded``): one exchange and one
    application for the rows.

    A plain x, inside ``blockwise_jvp``, is this rank's block and takes the
    form of its mesh; it must have the block's shape (ValueError otherwise).
    A DTensor that a ``torch.func`` transform wraps is dispatched by the
    DTensor it holds."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    inner = dtensor_of(x)
    found = _vmapped_rows(x) if inner is not None else None
    if found is not None and is_dtensor(found[3]):
        form = per_mesh(forms, found[3].device_mesh, make)
        if not isinstance(form, BlockSharded):
            refuse_row_block("this operator's sharded route", x)
        return form.on_rows(found)
    if inner is None:
        mesh, shape = _blockwise.block
        if tuple(x.shape) != shape:
            raise ValueError(
                f"inside blockwise_jvp a plain tensor is a rank's block of shape "
                f"{shape}; a stencil got one of shape {tuple(x.shape)}")
    else:
        mesh, places = inner.device_mesh, tuple(inner.placements)
        if mesh.ndim == 1 and places == (Replicate(),):
            return DTensor.from_local(plain(x.to_local()), mesh, places,
                                      run_check=False)
        if (mesh.ndim != 1 or places != (Shard(dim),)
                or x.shape[dim] % mesh.size()):
            raise NotImplementedError(
                f"a plain operator on a DTensor of shape {tuple(x.shape)} with "
                f"placements {places} on a {mesh.ndim}-D mesh: the halo route "
                f"takes [Shard({dim})] on a 1-D mesh, evenly, or [Replicate()]; "
                "no other placement is gathered (ROADMAP queue 1, item 8.5)")
    return per_mesh(forms, mesh, make)(x)


def blockwise_jvp(f: Callable, x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """J·v of ``f`` at the DTensor x, as a DTensor placed as x. Forward-mode
    AD makes no dual of a DTensor (``aten._has_same_storage_numel`` has no
    sharding rule), so ``torch.func.jvp`` runs on each rank's block inside a
    ``local_map``, in the blockwise mode: f's plain stencils take their halo
    forms there, and their tangents ``HaloStencil``'s rule (one exchange and
    one K1 launch each on the card). Only tensors shaped like the rank's
    block may be stenciled there. A ``[Replicate()]`` x is differentiated
    whole on every rank."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map

    mesh, places = x.device_mesh, tuple(x.placements)
    whole = places == (Replicate(),)

    def local(xb, vb):
        if whole:
            return torch.func.jvp(f, (xb,), (vb,))[1]
        outer = getattr(_blockwise, "block", None)
        _blockwise.block = (mesh, tuple(xb.shape))
        try:
            return torch.func.jvp(f, (xb,), (vb,))[1]
        finally:
            _blockwise.block = outer

    return local_map(local, out_placements=list(places), in_placements=(places, places),
                     device_mesh=mesh)(x, v)


def _float_coefs(coefs) -> tuple:
    """The coefficients as Python numbers (a 0-d tensor read once); a
    tracked coefficient raises (no rule carries its gradient through the
    halo route)."""
    out = []
    for c in coefs:
        if isinstance(c, torch.Tensor):
            if tracked_by(c) is not None:
                raise NotImplementedError(
                    "a tracked stencil coefficient on a sharded grid: the halo "
                    "route differentiates in x only (ROADMAP queue 1, item 8.5)")
            c = c.item()
        out.append(c)
    return tuple(out)


def _stencil_forms(x: torch.Tensor, key: tuple) -> dict:
    """The per-mesh dict (``ops/blas.py:per_mesh``) of the plain stencils'
    halo forms for the stencil kind and coefficient values ``key`` (numbers,
    not objects), on the mesh of x (a DTensor, or a rank's block inside
    ``blockwise_jvp``). The plain stencils are functions with no closure to
    keep them in, so the mesh keeps them: they live and die with it, where a
    module dict would keep every mesh, and its destroyed group, alive."""
    inner = dtensor_of(x)
    mesh = inner.device_mesh if inner is not None else _blockwise.block[0]
    return mesh.__dict__.setdefault("_gmres_tpu_torch_stencil_forms", {}).setdefault(key, {})


def sharded_stencil(x: torch.Tensor, kind: str, coefs) -> torch.Tensor:
    """The plain stencil ``kind`` on a DTensor x (or a rank's block inside
    ``blockwise_jvp``), through ``sharded_apply``: "5pt" with (c, w, e, s,
    n) — the ``HaloOperator`` (K1's halo form on the card, its transpose
    and tangent rules) for real coefficients and a real x, the complex halo
    form otherwise — or "7pt" with (center, off)."""
    from gmres_tpu_torch.ops.stencil import (
        stencil_5pt_general,
        stencil_5pt_pallas,
        stencil_7pt_general,
    )

    coefs = _float_coefs(coefs)
    if kind == "7pt":
        def local(blk, top, bottom):
            return stencil_7pt_halo(blk, top, bottom, *coefs)

        return sharded_apply(x, _stencil_forms(x, ("7pt",) + coefs),
                             lambda mesh: HaloForm(mesh, local, 0, 0),
                             lambda t: stencil_7pt_general(t, *coefs))
    if x.is_complex() or any(isinstance(c, complex) for c in coefs):
        def local(blk, top, bottom):
            return stencil_5pt_halo(blk, top, bottom, coefs)

        return sharded_apply(x, _stencil_forms(x, ("5pt complex",) + coefs),
                             lambda mesh: HaloForm(mesh, local, 0, 0),
                             lambda t: stencil_5pt_general(t, *coefs))
    return sharded_apply(x, _stencil_forms(x, ("5pt",) + coefs),
                         lambda mesh: HaloOperator(mesh, coefs, 0),
                         lambda t: stencil_5pt_pallas(t, coefs))


def _rdma_route(mesh, coefs7, group) -> BlockSharded:
    """The RDMA route's application of ``coefs7`` over ``group`` on each
    rank's block, or on its (s, rows, N) block of s rows (one message each
    way, one launch a step): the neighbours found once, the coefficients
    rounded once per dtype when first applied. Each application counts one
    exchange in ``halo_exchange.exchanges``."""
    neighbours = _neighbours(group)
    rounded = {}

    def apply_local(blk):
        c = rounded.get(blk.dtype)
        if c is None:
            c = rounded[blk.dtype] = _coefs7(coefs7, blk.dtype)
        halo_exchange.exchanges += 1
        return rdma_apply(blk.contiguous(), c, group, neighbours)

    return BlockSharded(mesh, apply_local)


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
    return _rdma_route(mesh, (*(float(c) for c in coefs), 0.0, 1.0), mesh.get_group(axis))


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
    return _rdma_route(mesh, coefs7, mesh.get_group(axis))


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
        # A (s, rows, N) block of s rows: one exchange, one K5 launch.
        top, bottom = _halo_rows(r_blk, group, neighbours, r_blk.dim() - 2)
        s = scal.get(r_blk.dtype) or cheb2_scalars(d, alpha, coefs, r_blk.dtype)
        return cheb2_apply(r_blk.contiguous(), top, bottom, s)

    return BlockSharded(mesh, m_inv_local)
