"""SPAI: the sparse approximate inverse preconditioner (Grote–Huckle 1997).

Counterpart of ``gmres_tpu/precond/spai.py``: M ≈ A⁻¹ with pattern(M) =
pattern(A), each column j minimising ‖A m_j − e_j‖₂ over its support. The
patterns are host CSR work in numpy (JAX's own arrays); the n local least
squares problems are embedded in fixed shapes from A's ELL widths (support
padded to w_c, residual rows to w_c², duplicates masked after a stable
sort) and solved in one batched pass of regularised (w_c × w_c) normal
equations, as JAX's ``jax.vmap`` does, here as batched torch operations on
the target device (``torch.linalg.solve_ex``: no device read to check the
factorisation). M comes back as the port's ``ELLMatrix``; applying it is one
``ell_spmv``.

On a row-sharded v (a ``[Shard(0)]`` DTensor) an application is one
all-gather of v and the rank's own rows of M (cut once per mesh): M's
pattern is arbitrary, so a row of M v may read any entry of v, and
gmres_tpu's GSPMD gathers v for the same reason. That all-gather is the
only collective of an application.
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import numpy as np
import torch

from gmres_tpu_torch.ops.blas import is_dtensor, per_mesh
from gmres_tpu_torch.ops.sparse import (
    CSRMatrix,
    ELLMatrix,
    all_gather_flat,
    ell_spmv,
    row_block,
)


def _to_host_csr(a):
    """(data, indices, indptr, shape) host arrays of a CSRMatrix or of a
    dense square matrix (numpy or tensor)."""
    if isinstance(a, CSRMatrix):
        return (a.data.detach().cpu().numpy(), a.indices.cpu().numpy(),
                a.indptr.cpu().numpy(), tuple(a.shape))
    a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    if a.ndim != 2 or a.shape[0] != a.shape[1]:
        raise ValueError(f"spai needs a square matrix, got {a.shape}")
    mask = a != 0
    indptr = np.zeros(a.shape[0] + 1, dtype=np.int64)
    np.cumsum(mask.sum(axis=1), out=indptr[1:])
    rows, cols = np.nonzero(mask)
    return a[rows, cols], cols.astype(np.int32), indptr, a.shape


def _padded_ell(data, indices, indptr, n, with_data=True):
    """Host ELL arrays (values, cols, valid mask) at the maximum row width."""
    counts = np.diff(indptr)
    w = max(int(counts.max()) if counts.size else 1, 1)
    d = np.zeros((n, w), dtype=data.dtype)
    c = np.zeros((n, w), dtype=np.int32)
    v = np.zeros((n, w), dtype=bool)
    nnz = len(indices)
    if nnz:
        rows = np.repeat(np.arange(n), counts)
        slot = np.arange(nnz) - indptr[rows]
        if with_data:
            d[rows, slot] = data
        c[rows, slot] = indices
        v[rows, slot] = True
    return d, c, v


def _solve_columns(a_d, a_c, a_v, at_c, at_v, cols, n, reg):
    """Batched local least squares for the columns ``cols`` (k,): the values
    of m_j on its support S_j = the nonzero rows of A's column j, (k, w_c)
    aligned with at_c[cols]. a_*: (n, w_r) row ELL of A; at_*: (n, w_c) row
    ELL pattern of Aᵀ (all tensors on one device)."""
    w_c = at_c.shape[1]
    s = at_c[cols]  # (k, w_c) support
    s_valid = at_v[cols]
    # Residual rows T_j = ∪ column patterns of S_j, padded to w_c² and
    # deduplicated: invalid entries sort last (key n), repeats are masked.
    t = at_c[s.long()].reshape(len(cols), -1)
    t_valid = (at_v[s.long()] & s_valid[:, :, None]).reshape(len(cols), -1)
    key = torch.where(t_valid, t, torch.full_like(t, n))
    order = torch.argsort(key, dim=1, stable=True)
    ts = torch.gather(t, 1, order)
    tvs = torch.gather(t_valid, 1, order)
    first = torch.cat([torch.ones_like(tvs[:, :1]), ts[:, 1:] != ts[:, :-1]], dim=1)
    row_valid = tvs & first
    # Â = A[T_j, S_j] by a one-hot contraction of the ELL rows.
    rd = a_d[ts.long()]  # (k, m, w_r)
    onehot = ((a_c[ts.long()][:, :, :, None] == s[:, None, None, :])
              & a_v[ts.long()][:, :, :, None] & s_valid[:, None, None, :])
    ahat = torch.einsum("kmt,kmtb->kmb", rd, onehot.to(rd.dtype))
    ahat = ahat * row_valid[:, :, None].to(rd.dtype)
    e = ((ts == cols[:, None]) & row_valid).to(rd.dtype)
    # Regularised conjugate-transpose normal equations.
    ah = ahat.conj().transpose(1, 2)
    g = ah @ ahat
    trace = torch.diagonal(g, dim1=1, dim2=2).sum(dim=1).real
    scale = torch.clamp(trace / w_c, min=torch.finfo(trace.dtype).tiny)
    g = g + (reg * scale)[:, None, None] * torch.eye(w_c, dtype=rd.dtype, device=rd.device)
    rhs = (ah @ e[:, :, None])
    m, _ = torch.linalg.solve_ex(g, rhs)
    return m[:, :, 0] * s_valid.to(rd.dtype)


def spai_matrix(
    a: Union[CSRMatrix, torch.Tensor, np.ndarray],
    *,
    reg: float = 1e-12,
    chunk: Optional[int] = None,
) -> ELLMatrix:
    """The SPAI approximate inverse M ≈ A⁻¹ with pattern(M) = pattern(A), as
    a row-ELL matrix for ``ell_spmv`` (the arguments of
    ``gmres_tpu.spai_matrix``).

      reg: relative Tikhonov weight of the local normal equations.
      chunk: solve the columns in chunks of this size (bounds the
        (chunk, w_c², w_r, w_c) one-hot buffer); default all at once.

    The local problems are solved, and M is kept, on the device of a
    CSRMatrix or tensor ``a``; a numpy ``a`` goes to the card.
    """
    device = (a.data.device if isinstance(a, CSRMatrix)
              else a.device if isinstance(a, torch.Tensor) else "cuda")
    data, indices, indptr, shape = _to_host_csr(a)
    n = shape[0]
    a_d, a_c, a_v = _padded_ell(data, indices, indptr, n)
    # The pattern of Aᵀ (the column supports of A), a host transpose.
    order = np.argsort(indices, kind="stable")
    rows = np.repeat(np.arange(n, dtype=np.int32), np.diff(indptr))
    t_indices = rows[order]
    t_indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(indices, minlength=n), out=t_indptr[1:])
    _, at_c, at_v = _padded_ell(data[order], t_indices, t_indptr, n, with_data=False)
    dev = [torch.as_tensor(v).to(device) for v in (a_d, a_c, a_v, at_c, at_v)]
    step = int(chunk) if chunk else n
    vals = np.concatenate([
        _solve_columns(*dev, torch.arange(lo, min(lo + step, n), device=device), n,
                       float(reg)).cpu().numpy()
        for lo in range(0, n, step)])
    # Scatter the column values (vals[j, b] = M[at_c[j, b], j]) into the row
    # ELL of M: the valid (row, col, value) triples stably sorted by row;
    # each entry's slot is its rank within its row.
    w_r = a_c.shape[1]
    m_d = np.zeros((n, w_r), dtype=vals.dtype)
    m_c = np.zeros((n, w_r), dtype=np.int32)
    jj, bb = np.nonzero(at_v)
    i_arr = at_c[jj, bb]
    order = np.argsort(i_arr, kind="stable")
    i_sorted = i_arr[order]
    slot = np.arange(len(i_sorted)) - np.searchsorted(i_sorted, i_sorted, side="left")
    m_d[i_sorted, slot] = vals[jj, bb][order]
    m_c[i_sorted, slot] = jj[order]
    return ELLMatrix(data=torch.as_tensor(m_d).to(device),
                     cols=torch.as_tensor(m_c).to(device), shape=shape)


def spai_preconditioner(
    a: Union[CSRMatrix, torch.Tensor, np.ndarray],
    *,
    reg: float = 1e-12,
    chunk: Optional[int] = None,
) -> Callable:
    """SPAI as a preconditioner: v ↦ M v, one ELL SpMV over v's flat length
    (the arguments of ``gmres_tpu.spai_preconditioner``)."""
    m = spai_matrix(a, reg=reg, chunk=chunk)
    own_rows = {}

    def apply(v: torch.Tensor) -> torch.Tensor:
        if is_dtensor(v):
            return sharded(v)
        return ell_spmv(m, v.reshape(-1)).reshape(v.shape)

    def sharded(v):
        from torch.distributed.tensor import DTensor, Shard

        mesh, places = v.device_mesh, tuple(v.placements)
        if mesh.ndim != 1 or places != (Shard(0),):
            raise NotImplementedError(
                f"spai_preconditioner on a DTensor with placements {places}: "
                "it takes a row-sharded v ([Shard(0)] on a 1-D mesh), as the "
                "sparse operators do")
        local = v.to_local().contiguous()

        def rows(mesh):
            lo = mesh.get_coordinate()[0] * local.numel()
            return row_block(m, lo, lo + local.numel())

        # The rank's rows of M after the application's one all-gather of v
        # (sparse_operator's route for an ELL matrix).
        whole = all_gather_flat(local, mesh.get_group())
        y = ell_spmv(per_mesh(own_rows, mesh, rows), whole).reshape(local.shape)
        return DTensor.from_local(y, mesh, places, run_check=False)

    return apply
