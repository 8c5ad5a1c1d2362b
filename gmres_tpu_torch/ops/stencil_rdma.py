"""The per-shard affine 5-point stencil of the RDMA route: kernel K8.

Counterpart of ``gmres_tpu/ops/stencil_rdma.py``. The TPU kernel starts two
one-row remote DMAs to the neighbouring chips from inside the kernel,
computes every term the block holds itself while they are in flight, and
only the two boundary-row corrections wait on the receives. Here the remote
copies are NCCL (on the card) or gloo (on the CPU) point-to-point messages
posted outside the kernel, in the same order:

1. post the one-row sends and receives toward each neighbour that exists
   (``batch_isend_irecv``);
2. compute the interior with zero halo rows,
   ``a·x + b·(c0·x + cw·W + ce·E + cs·S + cn·N)`` (K8's ``interior``);
3. wait on the receives;
4. add ``(b·cs)·top`` to row 0 and ``(b·cn)·bottom`` to the last row, for
   the rows that were received (K8's ``edges``).

On a CUDA block NCCL's point-to-point runs on its own stream, so the
interior launched before the wait overlaps the transfer, and the wait is a
stream dependency, not a host synchronisation: the structural overlap of the
TPU kernel's instruction order. A side with no neighbour (rank 0's top, the
last rank's bottom: the Dirichlet truncation) gets no row at all, where the
TPU kernel adds a zero row; that changes at most the sign of an exact zero
(``csrc/stencil5_rdma.cu``). On one rank no message is posted and no
``edges`` runs: an application is one launch. A CPU block takes the plain
versions of both steps. JAX's ``num_devices``, ``collective_id``,
``interpret`` and ``detect_races`` have no counterpart: the process group
carries the first two, and the device decides the rest.

The block form (what jax.vmap makes of the TPU kernel). A (lanes, rows, N)
block of s rows' blocks of a row-sharded grid is one application: one
message each way carries the s rows' first and last rows, one ``interior``
launch takes the block, and one ``edges`` launch the (lanes, 1, N) halo
rows, lane ℓ's its own; each lane gives the bits of its own application.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from gmres_tpu_torch.ops import _cuda
from gmres_tpu_torch.ops.stencil import _halo_row, stencil_5pt_general


def _neighbours(group) -> tuple[int | None, int | None]:
    """Global ranks of the ranks above and below this one in ``group``
    (None where there is none)."""
    rank, size = dist.get_rank(group), dist.get_world_size(group)
    up = dist.get_global_rank(group, rank - 1) if rank > 0 else None
    down = dist.get_global_rank(group, rank + 1) if rank < size - 1 else None
    return up, down


def post_halo_rows(blk: torch.Tensor, group, neighbours, dim: int = 0, width: int = 1):
    """Post the halo messages to the ``neighbours`` of ``_neighbours(group)``:
    this block's first ``width`` slices along ``dim`` up and its last
    ``width`` down, a receive of as many from each neighbour that exists.
    ``dim`` is the sharded dimension: 0 for a 2-D grid's rows or a 3-D grid's
    planes (or a flat vector's entries, ``width`` of them: a sparse band), 1
    for the rows of both planes of a (2, rows, N) stack (one message each
    way). Any dtype: a complex block travels as its real view. Returns (top,
    bottom, wait): each ``width`` along ``dim``, None for a side with no
    neighbour (nothing is allocated for it), and a function that waits for
    the receives."""
    up, down = neighbours
    shape = list(blk.shape)
    shape[dim] = width
    wire = torch.view_as_real if blk.is_complex() else (lambda t: t)
    top = bottom = None
    ops = []
    if up is not None:
        top = torch.empty(shape, dtype=blk.dtype, device=blk.device)
        ops += [dist.P2POp(dist.isend, wire(blk.narrow(dim, 0, width).contiguous()), up,
                           group),
                dist.P2POp(dist.irecv, wire(top), up, group)]
    if down is not None:
        bottom = torch.empty(shape, dtype=blk.dtype, device=blk.device)
        last = blk.narrow(dim, blk.shape[dim] - width, width).contiguous()
        ops += [dist.P2POp(dist.isend, wire(last), down, group),
                dist.P2POp(dist.irecv, wire(bottom), down, group)]
    reqs = dist.batch_isend_irecv(ops) if ops else []

    def wait():
        for req in reqs:
            req.wait()
        ops.clear()  # the send buffers lived in `ops` until now

    return top, bottom, wait


def _coefs7(coefs7, dtype: torch.dtype) -> list[float]:
    """(c0, cw, ce, cs, cn, a, b) rounded to the block's dtype, as the JAX
    operators round them (``jnp.asarray(..., dtype=blk.dtype)``)."""
    vals = [float(c) for c in coefs7]
    if len(vals) != 7:
        raise ValueError(f"expected 7 coefficients (c0, cw, ce, cs, cn, a, b), "
                         f"got {len(vals)}")
    return torch.tensor(vals, dtype=dtype).tolist()


def _edge_scales(c: list[float], dtype: torch.dtype) -> list[float]:
    """[b·cs, b·cn] multiplied in the block's dtype, as K8 forms them: the
    Python product of two values of the dtype, rounded once to it, is the
    dtype's own product."""
    b, cs, cn = c[6], c[3], c[4]
    return torch.tensor([b * cs, b * cn], dtype=dtype).tolist()


def rdma_interior_plain(x: torch.Tensor, c: list[float]) -> torch.Tensor:
    """The plain version of K8's interior step (zero halo rows), on a grid
    or a (lanes, rows, N) block of them."""
    c0, cw, ce, cs, cn, a, b = c
    return a * x + b * stencil_5pt_general(x, c0, cw, ce, cs, cn)


def rdma_edges_plain(y: torch.Tensor, top, bottom, c: list[float]) -> torch.Tensor:
    """The plain version of K8's edge step, in place on ``y``: row 0, then
    the last row (a one-row block takes both, in that order). A None row is
    no correction. On a (lanes, rows, N) block the halo rows are (lanes, 1,
    N), lane ℓ's its own."""
    bcs, bcn = _edge_scales(c, y.dtype)
    row = tuple(y.shape[:-2]) + (y.shape[-1],)
    if top is not None:
        y[..., 0, :] = y[..., 0, :] + bcs * top.reshape(row)
    if bottom is not None:
        y[..., -1, :] = y[..., -1, :] + bcn * bottom.reshape(row)
    return y


def _lanes(x: torch.Tensor) -> int:
    return x.shape[0] if x.dim() == 3 else 1


def rdma_interior_cuda(x: torch.Tensor, c: list[float]) -> torch.Tensor:
    """Launch K8's interior step on a CUDA block, or once on a (lanes, rows,
    N) block of them; ``c`` is the rounded (c0, cw, ce, cs, cn, a, b).
    ``rdma_interior_cuda.launches`` counts launches: one per application of
    the operator (to a grid or to a block of rows); ``.batched_launches``
    those on a block."""
    _cuda.check_grid("rdma_interior_cuda", "K8", x, lanes=True)
    y = torch.empty_like(x)
    rc = _cuda.entry("gt_rdma_interior", x.dtype)(
        x.data_ptr(), y.data_ptr(), _lanes(x), x.shape[-2], x.shape[-1], *c,
        x.device.index, _cuda.stream_of(x))
    _cuda.check(rc, "rdma_interior_cuda")
    rdma_interior_cuda.launches += 1
    rdma_interior_cuda.batched_launches += int(x.dim() == 3)
    return y


rdma_interior_cuda.launches = 0
rdma_interior_cuda.batched_launches = 0


def rdma_edges_cuda(y: torch.Tensor, top, bottom, c: list[float]) -> torch.Tensor:
    """Launch K8's edge step on a CUDA block, in place on ``y``, for the
    halo rows given (None: no correction on that side); on a (lanes, rows,
    N) block, one launch with (lanes, 1, N) halo rows, lane ℓ's its own.
    With neither row there is nothing to correct and nothing launches.
    ``rdma_edges_cuda.launches`` counts launches, ``.batched_launches``
    those on a block."""
    _cuda.check_grid("rdma_edges_cuda", "K8", y, lanes=True)
    top_p = _halo_row(top, y, "rdma_edges_cuda", "K8")
    bot_p = _halo_row(bottom, y, "rdma_edges_cuda", "K8")
    if top_p is None and bot_p is None:
        return y
    rc = _cuda.entry("gt_rdma_edges", y.dtype)(
        y.data_ptr(), top_p, bot_p, _lanes(y), y.shape[-2], y.shape[-1], c[6], c[3],
        c[4], y.device.index, _cuda.stream_of(y))
    _cuda.check(rc, "rdma_edges_cuda")
    rdma_edges_cuda.launches += 1
    rdma_edges_cuda.batched_launches += int(y.dim() == 3)
    return y


rdma_edges_cuda.launches = 0
rdma_edges_cuda.batched_launches = 0


def rdma_apply(blk: torch.Tensor, c: list[float], group, neighbours) -> torch.Tensor:
    """One application on this rank's block, with ``c`` the coefficients
    rounded to the block's dtype by ``_coefs7`` and ``neighbours`` from
    ``_neighbours(group)``: the RDMA operators' per-application entry. A
    (lanes, rows, N) block of s rows' blocks is one application of the
    block form: one message each way for the s rows, one launch a step."""
    cuda = blk.device.type != "cpu"
    if cuda:  # refuse before any message is posted, or the peers would hang
        _cuda.check_grid("stencil_5pt_rdma", "K8", blk, lanes=True)
    top, bottom, wait = post_halo_rows(blk, group, neighbours, blk.dim() - 2)
    y = rdma_interior_cuda(blk, c) if cuda else rdma_interior_plain(blk, c)
    if top is None and bottom is None:
        return y
    wait()
    if cuda:
        return rdma_edges_cuda(y, top, bottom, c)
    return rdma_edges_plain(y, top, bottom, c)


def stencil_5pt_rdma(blk: torch.Tensor, coefs7, group=None) -> torch.Tensor:
    """Per-shard affine stencil a·x + b·A(x) on this rank's (rows, N) block
    of a row-partitioned grid. ``coefs7`` is (c0, cw, ce, cs, cn, a, b);
    ``group`` the process group of the grid axis (None: the default group).
    (a, b) = (0, 1) is the plain stencil, (1/d + α, −α/d) the degree-2
    Chebyshev application. K8 on a CUDA block, the plain versions on a CPU
    block. The operators of ``parallel/halo.py`` round the coefficients and
    find the neighbours once; this entry does both on every call."""
    return rdma_apply(blk, _coefs7(coefs7, blk.dtype), group, _neighbours(group))
