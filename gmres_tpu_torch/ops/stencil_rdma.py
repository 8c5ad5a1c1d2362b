"""The per-shard affine 5-point stencil of the RDMA route: kernel K8.

Counterpart of ``gmres_tpu/ops/stencil_rdma.py``. The TPU kernel starts two
one-row remote DMAs to the neighbouring chips from inside the kernel,
computes every term the block holds itself while they are in flight, and
only the two boundary-row corrections wait on the receives. Here the remote
copies are NCCL (on the card) or gloo (on the CPU) point-to-point messages
posted outside the kernel, in the same order:

1. post the two one-row sends and receives (``batch_isend_irecv``);
2. compute the interior with zero halo rows,
   ``a·x + b·(c0·x + cw·W + ce·E + cs·S + cn·N)`` (K8's ``interior``);
3. wait on the receives;
4. add ``(b·cs)·top`` to row 0 and ``(b·cn)·bottom`` to the last row
   (K8's ``edges``).

On a CUDA block NCCL's point-to-point runs on its own stream, so the
interior launched before the wait overlaps the transfer, and the wait is a
stream dependency, not a host synchronisation: the structural overlap of the
TPU kernel's instruction order. Rank 0's top row and the last rank's bottom
row stay zero, which is the Dirichlet truncation. A CPU block takes the
plain versions of both steps. JAX's ``num_devices``, ``collective_id``,
``interpret`` and ``detect_races`` have no counterpart: the process group
carries the first two, and the device decides the rest.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from gmres_tpu_torch.ops import _cuda
from gmres_tpu_torch.ops.stencil import _halo_row, stencil_5pt_general


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
    """The plain version of K8's interior step (zero halo rows)."""
    c0, cw, ce, cs, cn, a, b = c
    return a * x + b * stencil_5pt_general(x, c0, cw, ce, cs, cn)


def rdma_edges_plain(y: torch.Tensor, top: torch.Tensor, bottom: torch.Tensor,
                     c: list[float]) -> torch.Tensor:
    """The plain version of K8's edge step, in place on ``y``: row 0, then
    the last row (a one-row block takes both, in that order)."""
    bcs, bcn = _edge_scales(c, y.dtype)
    y[0] = y[0] + bcs * top.reshape(-1)
    y[-1] = y[-1] + bcn * bottom.reshape(-1)
    return y


def rdma_interior_cuda(x: torch.Tensor, c: list[float]) -> torch.Tensor:
    """Launch K8's interior step on a CUDA block; ``c`` is the rounded
    (c0, cw, ce, cs, cn, a, b). ``rdma_interior_cuda.launches`` counts
    launches: one per application of the operator."""
    _cuda.check_grid(x, "rdma_interior_cuda")
    y = torch.empty_like(x)
    fn = getattr(_cuda.load(), f"gt_rdma_interior_{_cuda.suffix(x.dtype)}")
    rc = fn(x.data_ptr(), y.data_ptr(), x.shape[0], x.shape[1], *c,
            x.device.index, _cuda.stream_of(x))
    _cuda.check(rc, "rdma_interior_cuda")
    rdma_interior_cuda.launches += 1
    return y


rdma_interior_cuda.launches = 0


def rdma_edges_cuda(y: torch.Tensor, top: torch.Tensor, bottom: torch.Tensor,
                    c: list[float]) -> torch.Tensor:
    """Launch K8's edge step on a CUDA block, in place on ``y``.
    ``rdma_edges_cuda.launches`` counts launches."""
    _cuda.check_grid(y, "rdma_edges_cuda")
    if top is None or bottom is None:
        raise ValueError("rdma_edges_cuda: both halo rows are needed (zeros "
                         "where there is no neighbour)")
    top_p = _halo_row(top, y, "rdma_edges_cuda")
    bot_p = _halo_row(bottom, y, "rdma_edges_cuda")
    fn = getattr(_cuda.load(), f"gt_rdma_edges_{_cuda.suffix(y.dtype)}")
    rc = fn(y.data_ptr(), top_p, bot_p, y.shape[0], y.shape[1], c[6], c[3],
            c[4], y.device.index, _cuda.stream_of(y))
    _cuda.check(rc, "rdma_edges_cuda")
    rdma_edges_cuda.launches += 1
    return y


rdma_edges_cuda.launches = 0


def stencil_5pt_rdma(blk: torch.Tensor, coefs7, group=None) -> torch.Tensor:
    """Per-shard affine stencil a·x + b·A(x) on this rank's (rows, N) block
    of a row-partitioned grid. ``coefs7`` is (c0, cw, ce, cs, cn, a, b);
    ``group`` the process group of the grid axis (None: the default group).
    (a, b) = (0, 1) is the plain stencil, (1/d + α, −α/d) the degree-2
    Chebyshev application. K8 on a CUDA block, the plain versions on a CPU
    block."""
    c = _coefs7(coefs7, blk.dtype)
    cuda = blk.device.type != "cpu"
    if cuda:  # refuse before any message is posted, or the peers would hang
        _cuda.check_grid(blk, "stencil_5pt_rdma")
    ncols = blk.shape[1]
    top = torch.zeros((1, ncols), dtype=blk.dtype, device=blk.device)
    bottom = torch.zeros_like(top)
    rank, size = dist.get_rank(group), dist.get_world_size(group)
    ops = []
    if rank > 0:
        up = dist.get_global_rank(group, rank - 1)
        ops += [dist.P2POp(dist.isend, blk[:1].contiguous(), up, group),
                dist.P2POp(dist.irecv, top, up, group)]
    if rank < size - 1:
        down = dist.get_global_rank(group, rank + 1)
        ops += [dist.P2POp(dist.isend, blk[-1:].contiguous(), down, group),
                dist.P2POp(dist.irecv, bottom, down, group)]
    # The send buffers live in `ops` until the waits below.
    reqs = dist.batch_isend_irecv(ops) if ops else []
    y = rdma_interior_cuda(blk, c) if cuda else rdma_interior_plain(blk, c)
    for req in reqs:
        req.wait()
    if cuda:
        return rdma_edges_cuda(y, top, bottom, c)
    return rdma_edges_plain(y, top, bottom, c)
