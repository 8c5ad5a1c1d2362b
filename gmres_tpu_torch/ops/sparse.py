"""Sparse-matrix formats and SpMV: containers, host-side constructors, the
plain PyTorch SpMVs and kernels K3 and K4.

Counterpart of ``gmres_tpu/ops/sparse.py``, with the same names:

* **Containers** ``CSRMatrix``, ``COOMatrix``, ``ELLMatrix``, ``DIAMatrix``,
  ``HYBMatrix`` and ``BSRMatrix``: frozen dataclasses over tensors, with
  ``shape`` (and DIA's ``offsets``) as plain-tuple metadata. Indices are
  int32, as in JAX.
* **Host-side constructors** (``csr_from_dense`` … ``bsr_from_dense``): the
  same numpy code as the JAX module, so the same split and the same order
  come out; the arrays are then placed on an explicit ``device`` (the card
  unless the caller asks for the CPU) and ``dtype``. The converters that
  take a container (``csr_to_ell``, ``csr_to_hyb``, ``coo_to_hyb``) leave
  their result on the input's device. ``sparse_from_numpy`` builds a
  container from the numpy arrays of a JAX container's fields: the way to
  hand the very same matrix to both packages.
* **Plain SpMVs** (``dia_spmv``, ``csr_spmv``, ``coo_spmv``, ``ell_spmv``,
  ``bsr_spmv``): JAX computes them outside any Pallas kernel, so plain
  PyTorch is their port (``index_add_`` takes the place of
  ``segment_sum``). They run on any device.
* **Kernels.** ``dia_spmv_pallas`` is kernel K3 (``csrc/dia_spmv.cu``) and
  ``bsr_spmv_pallas`` kernel K4 (``csrc/bsr_spmv.cu``), behind the names
  and data arguments of the Pallas entry points. A CPU tensor takes the
  plain version, a CUDA tensor of float32 or float64 launches the kernel,
  and any other CUDA dtype raises. Each also takes a (lanes, n_cols) block
  with one matrix for every lane, what ``jax.vmap`` makes of the Pallas
  kernel (a leading grid axis): one launch, each lane its own launch's
  bits; under ``torch.func.vmap`` their vmap rule (``SpmvLanes``) hands
  the lanes' block to that form.
* ``hyb_spmv`` and ``sparse_operator`` route by device in the same way: on
  a CUDA tensor, DIA and the DIA part of HYB always run in K3, and BSR in
  K4; HYB's ELL residue is the plain gather, as in JAX.
* The sharded route: ``sparse_operator`` on a row-sharded DTensor x applies
  each rank's rows of the matrix (``_RankRows``), where gmres_tpu's GSPMD
  partitions the gathers and rolls: a band (DIA, HYB's DIA part, BSR)
  after one halo exchange of its width, with K3 or K4 on the rank's rows,
  the other formats after one all-gather of x. The kernels see the rank's
  plain tensors only. A block of s rows of a sharded x (``ops/blas.py:
  row_apply``, what ``jax.vmap`` makes of the operator) makes one row's
  collectives for the s rows and one K3 or K4 launch on the rank's lane
  block.

JAX's ``use_pallas``, ``interpret`` and ``block_rows`` have no
counterpart: the tensor's device decides, and one launch covers any size.
An operand on another device than the matrix raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch

from gmres_tpu_torch.ops import _cuda
from gmres_tpu_torch.ops.blas import dtensor_of, row_blocks


@dataclasses.dataclass(frozen=True)
class CSRMatrix:
    """Compressed sparse rows: data (nnz,), indices (nnz,) column ids,
    indptr (nrows+1,) row offsets."""

    data: torch.Tensor
    indices: torch.Tensor
    indptr: torch.Tensor
    shape: tuple

    @property
    def nnz(self) -> int:
        return self.data.shape[0]


@dataclasses.dataclass(frozen=True)
class COOMatrix:
    """Coordinate format: data/row/col all (nnz,), rows sorted ascending."""

    data: torch.Tensor
    row: torch.Tensor
    col: torch.Tensor
    shape: tuple

    @property
    def nnz(self) -> int:
        return self.data.shape[0]


@dataclasses.dataclass(frozen=True)
class ELLMatrix:
    """ELLPACK: data (nrows, k), cols (nrows, k); padding entries have
    value 0 and column 0 (they contribute nothing)."""

    data: torch.Tensor
    cols: torch.Tensor
    shape: tuple

    @property
    def row_width(self) -> int:
        return self.data.shape[1]


@dataclasses.dataclass(frozen=True)
class DIAMatrix:
    """Diagonal format: data (ndiags, n) holds each diagonal aligned to
    ROW index (data[k, i] = A[i, i + offsets[k]], zero where out of
    range)."""

    data: torch.Tensor
    offsets: tuple
    shape: tuple

    @property
    def ndiags(self) -> int:
        return self.data.shape[0]


@dataclasses.dataclass(frozen=True)
class HYBMatrix:
    """Hybrid DIA + ELL: well-occupied diagonals in ``dia``, straggler
    entries in a small-k ``ell`` residue (None when the matrix is fully
    diagonal). Built by ``csr_to_hyb``/``coo_to_hyb``."""

    dia: DIAMatrix
    ell: ELLMatrix | None
    shape: tuple

    @property
    def nnz_dia(self) -> int:
        return int((self.dia.data != 0).sum())


@dataclasses.dataclass(frozen=True)
class BSRMatrix:
    """Block-sparse rows with dense (bs, bs) blocks in ELL layout:
    data (n_block_rows, k, bs, bs), block_cols (n_block_rows, k); padding
    blocks are all-zero with block-column 0."""

    data: torch.Tensor
    block_cols: torch.Tensor
    shape: tuple

    @property
    def block_size(self) -> int:
        return self.data.shape[-1]


# ---------------------------------------------------------------------------
# Construction (host-side numpy, then placed on the device).
# ---------------------------------------------------------------------------


def _values(a: np.ndarray, device, dtype=None) -> torch.Tensor:
    """A copy of ``a`` on ``device`` (the caller's array is never aliased),
    cast to ``dtype`` when given."""
    t = torch.from_numpy(np.array(a, order="C")).to(device)
    return t if dtype is None else t.to(dtype)


def _index(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.int32, order="C")).to(device)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def csr_from_dense(a, tol: float = 0.0, device="cuda", dtype=None) -> CSRMatrix:
    """Build CSR from a dense matrix (host-side; numpy)."""
    a = np.asarray(a)
    mask = np.abs(a) > tol
    row_counts = mask.sum(axis=1)
    indptr = np.zeros(a.shape[0] + 1, dtype=np.int32)
    np.cumsum(row_counts, out=indptr[1:])
    rows, cols = np.nonzero(mask)
    return CSRMatrix(
        data=_values(a[rows, cols], device, dtype),
        indices=_index(cols, device),
        indptr=_index(indptr, device),
        shape=a.shape,
    )


def coo_from_dense(a, tol: float = 0.0, device="cuda", dtype=None) -> COOMatrix:
    a = np.asarray(a)
    rows, cols = np.nonzero(np.abs(a) > tol)  # row-major ⇒ rows sorted
    return COOMatrix(
        data=_values(a[rows, cols], device, dtype),
        row=_index(rows, device),
        col=_index(cols, device),
        shape=a.shape,
    )


def ell_from_dense(a, tol: float = 0.0, device="cuda", dtype=None) -> ELLMatrix:
    a = np.asarray(a)
    mask = np.abs(a) > tol
    k = max(int(mask.sum(axis=1).max()), 1)
    nrows = a.shape[0]
    data = np.zeros((nrows, k), dtype=a.dtype)
    cols = np.zeros((nrows, k), dtype=np.int32)
    for i in range(nrows):
        (nz,) = np.nonzero(mask[i])
        data[i, : nz.size] = a[i, nz]
        cols[i, : nz.size] = nz
    return ELLMatrix(data=_values(data, device, dtype),
                     cols=_index(cols, device), shape=a.shape)


def csr_to_ell(a: CSRMatrix, row_width: int | None = None) -> ELLMatrix:
    """Repack CSR as ELL (host-side), on the input's device."""
    data = _host(a.data)
    indices = _host(a.indices)
    indptr = _host(a.indptr)
    counts = np.diff(indptr)
    k = int(row_width if row_width is not None else max(counts.max(), 1))
    nrows = a.shape[0]
    out_d = np.zeros((nrows, k), dtype=data.dtype)
    out_c = np.zeros((nrows, k), dtype=np.int32)
    for i in range(nrows):
        lo, hi = indptr[i], indptr[i + 1]
        out_d[i, : hi - lo] = data[lo:hi]
        out_c[i, : hi - lo] = indices[lo:hi]
    dev = a.data.device
    return ELLMatrix(data=_values(out_d, dev), cols=_index(out_c, dev),
                     shape=a.shape)


def poisson_csr(nsize: int, dtype=torch.float64, device="cuda") -> CSRMatrix:
    """5-point Laplacian (C-order flattening) assembled directly in CSR,
    never densified."""
    n = nsize * nsize
    idx = np.arange(n)
    i, j = idx // nsize, idx % nsize
    diags = []  # (offset, values, valid-mask)
    diags.append((0, np.full(n, 4.0), np.ones(n, bool)))
    diags.append((-nsize, np.full(n, -1.0), i > 0))
    diags.append((-1, np.full(n, -1.0), j > 0))
    diags.append((1, np.full(n, -1.0), j < nsize - 1))
    diags.append((nsize, np.full(n, -1.0), i < nsize - 1))
    rows, cols, vals = [], [], []
    for off, v, m in diags:
        rows.append(idx[m])
        cols.append(idx[m] + off)
        vals.append(v[m])
    rows = np.concatenate(rows)
    cols = np.concatenate(cols)
    vals = np.concatenate(vals)
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(indptr, rows + 1, 1)
    np.cumsum(indptr, out=indptr)
    return CSRMatrix(
        data=_values(vals, device, dtype),
        indices=_index(cols, device),
        indptr=_index(indptr, device),
        shape=(n, n),
    )


def dia_from_dense(a, tol: float = 0.0, device="cuda", dtype=None) -> DIAMatrix:
    """Extract every nonzero diagonal (host-side)."""
    a = np.asarray(a)
    n = a.shape[0]
    offsets = []
    rows = []
    for off in range(-(n - 1), n):
        d = np.diagonal(a, offset=off)
        if np.any(np.abs(d) > tol):
            row = np.zeros(n, dtype=a.dtype)
            if off >= 0:
                row[: n - off] = d
            else:
                row[-off:] = d
            offsets.append(off)
            rows.append(row)
    return DIAMatrix(
        data=_values(np.stack(rows) if rows else np.zeros((1, n)), device, dtype),
        offsets=tuple(offsets) if offsets else (0,),
        shape=a.shape,
    )


def csr_to_hyb(
    a: CSRMatrix,
    min_occupancy: float = 0.25,
    max_diags: int = 64,
) -> HYBMatrix:
    """Split CSR into DIA (diagonals occupied on ≥ min_occupancy of
    eligible rows; when more than max_diags qualify, the most-covered are
    kept) + an ELL residue for the leftovers (host-side, on the input's
    device). The split is exact: every nonzero lands in exactly one part."""
    n_rows, n_cols = a.shape
    data = _host(a.data)
    indices = _host(a.indices)
    indptr = _host(a.indptr)
    dev = a.data.device
    rows = np.repeat(np.arange(n_rows), np.diff(indptr))
    offs = indices.astype(np.int64) - rows
    uniq, counts = np.unique(offs, return_counts=True)
    # Occupancy relative to the diagonal's maximum possible length.
    max_len = np.minimum(n_rows - np.maximum(uniq, 0),
                         n_cols + np.minimum(uniq, 0))
    occ = counts / np.maximum(max_len, 1)
    eligible = occ >= min_occupancy
    chosen = uniq[eligible]
    if chosen.size > max_diags:
        # Most-covered first, with numpy's argsort order among ties, as in
        # the JAX module.
        order = np.argsort(-counts[eligible])
        chosen = chosen[order[:max_diags]]
    dia_offsets = tuple(int(o) for o in np.sort(chosen))
    dia_data = np.zeros((max(len(dia_offsets), 1), n_rows),
                        dtype=data.dtype)
    in_dia = np.isin(offs, chosen)
    if dia_offsets:
        k_idx = np.searchsorted(np.asarray(dia_offsets), offs[in_dia])
        dia_data[k_idx, rows[in_dia]] = data[in_dia]

    res_mask = ~in_dia
    ell = None
    if res_mask.any():
        r_rows = rows[res_mask]  # sorted (CSR order)
        r_cols = indices[res_mask]
        r_data = data[res_mask]
        counts_r = np.bincount(r_rows, minlength=n_rows)
        k = int(counts_r.max())
        ell_d = np.zeros((n_rows, k), dtype=data.dtype)
        ell_c = np.zeros((n_rows, k), dtype=np.int32)
        starts = np.zeros(n_rows + 1, dtype=np.int64)
        np.cumsum(counts_r, out=starts[1:])
        slot = np.arange(r_rows.size) - starts[r_rows]
        ell_d[r_rows, slot] = r_data
        ell_c[r_rows, slot] = r_cols
        ell = ELLMatrix(data=_values(ell_d, dev), cols=_index(ell_c, dev),
                        shape=a.shape)
    dia = DIAMatrix(
        data=_values(dia_data, dev),
        offsets=dia_offsets if dia_offsets else (0,),
        shape=a.shape,
    )
    return HYBMatrix(dia=dia, ell=ell, shape=a.shape)


def coo_to_hyb(
    a: COOMatrix, min_occupancy: float = 0.25, max_diags: int = 64
) -> HYBMatrix:
    """COO → HYB via the CSR splitter (host-side; rows must be sorted, the
    COOMatrix contract)."""
    row = _host(a.row)
    indptr = np.zeros(a.shape[0] + 1, dtype=np.int64)
    np.add.at(indptr, row + 1, 1)
    np.cumsum(indptr, out=indptr)
    csr = CSRMatrix(data=a.data, indices=a.col,
                    indptr=_index(indptr, a.data.device), shape=a.shape)
    return csr_to_hyb(csr, min_occupancy=min_occupancy, max_diags=max_diags)


def poisson_dia(nsize: int, dtype=torch.float64, device="cuda") -> DIAMatrix:
    """5-point Laplacian directly in DIA (never densified): offsets
    (−N, −1, 0, 1, N)."""
    n = nsize * nsize
    j = np.arange(n) % nsize
    main = np.full(n, 4.0)
    west = np.where(j > 0, -1.0, 0.0)    # A[i, i-1]
    east = np.where(j < nsize - 1, -1.0, 0.0)  # A[i, i+1]
    north = np.full(n, -1.0)
    north[n - nsize:] = 0.0              # A[i, i+N] valid for i < n-N
    south = np.full(n, -1.0)
    south[:nsize] = 0.0                  # A[i, i-N] valid for i >= N
    data = np.stack([south, west, main, east, north])
    return DIAMatrix(
        data=_values(data, device, dtype),
        offsets=(-nsize, -1, 0, 1, nsize),
        shape=(n, n),
    )


def bsr_from_dense(a, block_size: int, tol: float = 0.0, device="cuda",
                   dtype=None) -> BSRMatrix:
    """Blocked ELL from dense (host-side). Rows/cols must divide by
    block_size; a block is kept if any entry is nonzero."""
    a = np.asarray(a)
    bs = block_size
    nbr, nbc = a.shape[0] // bs, a.shape[1] // bs
    blocks = a.reshape(nbr, bs, nbc, bs).transpose(0, 2, 1, 3)
    occupied = np.abs(blocks).max(axis=(2, 3)) > tol  # (nbr, nbc)
    k = max(int(occupied.sum(axis=1).max()), 1)
    data = np.zeros((nbr, k, bs, bs), dtype=a.dtype)
    cols = np.zeros((nbr, k), dtype=np.int32)
    for i in range(nbr):
        (nz,) = np.nonzero(occupied[i])
        data[i, : nz.size] = blocks[i, nz]
        cols[i, : nz.size] = nz
    return BSRMatrix(data=_values(data, device, dtype),
                     block_cols=_index(cols, device), shape=a.shape)


def _check_range(name: str, idx: np.ndarray, hi: int) -> None:
    if idx.size and (idx.min() < 0 or idx.max() >= hi):
        raise ValueError(f"{name}: index out of range [0, {hi})")


def sparse_from_numpy(kind: str, arrays: dict, shape, offsets=None,
                      device="cuda"):
    """A port container from the numpy arrays of a JAX container's fields
    (``kind`` is "csr", "coo", "ell", "dia", "hyb" or "bsr"; the keys of
    ``arrays`` are the field names). A HYB takes nested dicts for ``dia``
    and ``ell`` (``ell`` may be None), and ``offsets`` for its DIA part.
    Values keep their dtype, indices become int32, and indices outside the
    matrix raise."""
    shape = tuple(int(s) for s in shape)
    n_rows, n_cols = shape
    arr = {k: (v if isinstance(v, dict) or v is None else np.asarray(v))
           for k, v in arrays.items()}
    if kind == "csr":
        _check_range("csr indices", arr["indices"], n_cols)
        return CSRMatrix(data=_values(arr["data"], device),
                         indices=_index(arr["indices"], device),
                         indptr=_index(arr["indptr"], device), shape=shape)
    if kind == "coo":
        _check_range("coo row", arr["row"], n_rows)
        _check_range("coo col", arr["col"], n_cols)
        return COOMatrix(data=_values(arr["data"], device),
                         row=_index(arr["row"], device),
                         col=_index(arr["col"], device), shape=shape)
    if kind == "ell":
        _check_range("ell cols", arr["cols"], n_cols)
        return ELLMatrix(data=_values(arr["data"], device),
                         cols=_index(arr["cols"], device), shape=shape)
    if kind == "dia":
        if offsets is None or len(offsets) != arr["data"].shape[0]:
            raise ValueError("dia: one offset per row of data is required")
        return DIAMatrix(data=_values(arr["data"], device),
                         offsets=tuple(int(o) for o in offsets), shape=shape)
    if kind == "hyb":
        ell = arr.get("ell")
        return HYBMatrix(
            dia=sparse_from_numpy("dia", arr["dia"], shape, offsets, device),
            ell=None if ell is None else sparse_from_numpy("ell", ell, shape,
                                                           device=device),
            shape=shape)
    if kind == "bsr":
        bs = arr["data"].shape[-1]
        _check_range("bsr block_cols", arr["block_cols"], n_cols // bs)
        return BSRMatrix(data=_values(arr["data"], device),
                         block_cols=_index(arr["block_cols"], device),
                         shape=shape)
    raise ValueError(f"unknown sparse kind {kind!r}")


# ---------------------------------------------------------------------------
# Plain SpMVs (any device).
# ---------------------------------------------------------------------------


def _operand(x: torch.Tensor, n_cols: int) -> torch.Tensor:
    """x read flat: (n_cols,) for one operand of n_cols entries (any shape),
    or a (lanes, n_cols) block of lanes as it is (what a vmap rule hands a
    sparse product: one operand a lane)."""
    if x.numel() != n_cols and x.dim() == 2 and x.shape[1] == n_cols:
        return x
    return x.reshape(-1)


def dia_spmv(a: DIAMatrix, x: torch.Tensor) -> torch.Tensor:
    """y_i = Σ_k data[k, i] · x[i + off_k]: one roll + multiply-add per
    diagonal in offset order, from zeros. Out-of-range positions carry zero
    coefficients by construction, so the roll's wrap-around adds 0·x there
    (a NaN or Inf of x at a wrapped position would still poison y; K3 never
    reads those positions). A (lanes, n_cols) block gives (lanes, n_rows),
    each lane's sums those of its own product.

    A block of rows (n_rows ≠ n_cols: a rank's rows with its halo-widened
    x, ``sparse_operator``'s sharded route) reads x through a zero-padded
    window instead of a roll, the same sums in the same order."""
    n_rows, n_cols = a.shape
    xf = _operand(x, n_cols)
    if n_rows == n_cols:
        y = torch.zeros_like(xf)
        for k, off in enumerate(a.offsets):
            y = y + a.data[k] * torch.roll(xf, -off, dims=-1)
        return y
    lo = max(0, -min(a.offsets))
    hi = max(0, n_rows + max(a.offsets) - n_cols)
    xp = torch.nn.functional.pad(xf, (lo, hi))
    y = torch.zeros(xf.shape[:-1] + (n_rows,), dtype=xf.dtype, device=xf.device)
    for k, off in enumerate(a.offsets):
        y = y + a.data[k] * xp[..., lo + off:lo + off + n_rows]
    return y


def csr_row_ids(a: CSRMatrix) -> torch.Tensor:
    """Per-nnz row ids from indptr (one searchsorted); loop-invariant for a
    fixed matrix (``sparse_operator`` computes it once)."""
    return torch.searchsorted(
        a.indptr, torch.arange(a.nnz, dtype=a.indptr.dtype,
                               device=a.indptr.device),
        right=True, out_int32=True,
    ) - 1


def _segment_sum(prod: torch.Tensor, rows: torch.Tensor, n: int) -> torch.Tensor:
    # Out of place, so that under torch.func.vmap the zeros take the lanes
    # of prod (an in-place add of a batched prod into them cannot).
    return torch.zeros(n, dtype=prod.dtype, device=prod.device).index_add(
        0, rows, prod)


def csr_spmv(a: CSRMatrix, x: torch.Tensor,
             rows: torch.Tensor | None = None) -> torch.Tensor:
    """y = A x: products gathered per nonzero, summed into rows with
    ``index_add_`` (``rows`` from ``csr_row_ids``, recomputed when not
    supplied)."""
    if rows is None:
        rows = csr_row_ids(a)
    prod = a.data * x.reshape(-1)[a.indices]
    return _segment_sum(prod, rows, a.shape[0])


def coo_spmv(a: COOMatrix, x: torch.Tensor) -> torch.Tensor:
    prod = a.data * x.reshape(-1)[a.col]
    return _segment_sum(prod, a.row, a.shape[0])


def ell_spmv(a: ELLMatrix, x: torch.Tensor) -> torch.Tensor:
    """y = A x: one gather (nrows, k) + one dense row reduction."""
    return torch.sum(a.data * x.reshape(-1)[a.cols], dim=1)


def bsr_spmv(a: BSRMatrix, x: torch.Tensor) -> torch.Tensor:
    """Gather the x blocks, batched block matvec (einsum), in the promoted
    dtype of the blocks and x, returned in x's dtype (JAX's
    ``preferred_element_type=x.dtype``). A (lanes, n_cols) block gives
    (lanes, n_rows): the lanes join the block rows as the einsum's batch,
    so each lane's sums are those of its own product."""
    bs = a.block_size
    xf = _operand(x, a.shape[1])
    lanes = xf.shape[0] if xf.dim() == 2 else 1
    nbr, k = a.block_cols.shape
    gathered = xf.reshape(lanes, -1, bs)[:, a.block_cols]  # (lanes, nbr, k, bs)
    dt = torch.promote_types(a.data.dtype, x.dtype)
    data = a.data.to(dt).expand((lanes,) + tuple(a.data.shape))
    y = torch.einsum("rkab,rkb->ra", data.reshape((lanes * nbr,) + tuple(a.data.shape[1:])),
                     gathered.reshape(lanes * nbr, k, bs).to(dt)).to(x.dtype)
    return y.reshape(xf.shape[:-1] + (nbr * bs,))


# ---------------------------------------------------------------------------
# Kernels K3 and K4.
# ---------------------------------------------------------------------------

# K3 takes its offsets as kernel parameters, at most this many per launch;
# a DIA with more diagonals runs in several launches, each adding its
# diagonals to the previous one's y in offset order (the same order of sums
# as one launch). Must match kMaxDiags in csrc/dia_spmv.cu.
DIA_MAX_DIAGS_PER_LAUNCH = 64

# K3 and K4 run a block's lanes in chunks: a CUDA block carries up to L lanes
# and reads each matrix entry once for all of them. The chunk sizes L that
# csrc/dia_spmv.cu and csrc/bsr_spmv.cu compile (K3_CHUNKS, K4_CHUNKS_F32 and
# K4_CHUNKS_F64 there), each routed by spmv_lanes_plan; a launch with any
# other raises. K4 stops float64 at chunks of 4: a chunk of 8 holds too few
# warps an SM (its registers), and two chunks of 4 measured faster on the
# H100 (PERF.md §6, row 11b).
K3_CHUNKS = (1, 2, 4, 8, 16)
K4_CHUNKS = {torch.float32: (1, 2, 4, 8), torch.float64: (1, 2, 4)}
K4_ROWS_PER_WARP = 4  # kRowsPerWarp in csrc/bsr_spmv.cu: a CUDA block 32 rows
SPMV_THREADS = 256    # both kernels' CUDA block (K4: 8 warps)
K4_MAX_BLOCK = 46340  # the largest bs with bs² < 2³¹ (one block's entries)
_MAX_GRID_X = 2**31 - 1


class SpmvLanesPlan(NamedTuple):
    """K3's or K4's launch on a block of lanes: ``chunk`` lanes a CUDA block
    (L; the last chunk holds the rest), ``chunks`` of them, and the
    launch's ``grid``, ``threads`` and dynamic ``shared_bytes``, which the
    wrappers pass to the kernel's C entry as they are."""

    chunk: int
    chunks: int
    grid: tuple
    threads: int
    shared_bytes: int


def spmv_lanes_plan(kernel: str, lanes: int, dtype: torch.dtype, rows: int,
                    bs: int | None = None) -> SpmvLanesPlan:
    """How ``kernel`` ("K3" or "K4") launches on ``lanes`` lanes of ``dtype``
    (1: one vector): ``rows`` is K3's matrix rows or K4's block rows, ``bs``
    K4's block size. Plain Python, no card.

    The chunk is the smallest compiled one that holds the lanes, else the
    largest (K3: 16; K4: 8 in float32, 4 in float64); a launch takes
    ``ceil(lanes / L)`` consecutive chunks, in order. K3's grid is (row
    blocks, chunks); K4's is one dimension, (block row, tile of 32 rows,
    chunk) with the chunk fastest, so the chunks of one tile run side by
    side. Neither kernel stages anything in shared memory (K4 keeps its
    chunk's x entries in registers), so no block size is refused for want
    of it. The C entries refuse a grid that does not cover their work.
    Raises TypeError for a dtype other than float32 or float64 and
    ValueError for what the kernel cannot take."""
    _cuda.suffix(dtype)
    if not 1 <= lanes <= _cuda.MAX_LANES:
        raise ValueError(f"spmv_lanes_plan: {lanes} lanes (1 to {_cuda.MAX_LANES})")
    if rows < 0:
        raise ValueError(f"spmv_lanes_plan: {rows} rows")
    if kernel not in ("K3", "K4"):
        raise ValueError(f"spmv_lanes_plan: kernel {kernel!r} (K3 or K4)")
    if kernel == "K3" and bs is not None:
        raise ValueError("spmv_lanes_plan: K3 takes no block size")
    if kernel == "K4" and (bs is None or not 1 <= bs <= K4_MAX_BLOCK):
        raise ValueError(f"spmv_lanes_plan: K4 takes blocks of 1 to {K4_MAX_BLOCK} "
                         f"rows, not {bs}")
    compiled = K3_CHUNKS if kernel == "K3" else K4_CHUNKS[dtype]
    chunk = next((c for c in compiled if c >= lanes), compiled[-1])
    chunks = -(-lanes // chunk)
    if kernel == "K3":
        grid = (-(-rows // SPMV_THREADS), chunks, 1)
    else:
        grid = (rows * -(-bs // (SPMV_THREADS // 32 * K4_ROWS_PER_WARP)) * chunks, 1, 1)
    if grid[0] > _MAX_GRID_X:
        raise ValueError(f"spmv_lanes_plan: {kernel} on {rows} rows and {lanes} "
                         f"lanes needs {grid[0]} CUDA blocks, more than one launch "
                         "takes")
    return SpmvLanesPlan(chunk, chunks, grid, SPMV_THREADS, 0)


def _check_same_device(what: str, x: torch.Tensor, *tensors) -> None:
    for t in tensors:
        if t.device != x.device:
            raise ValueError(f"{what}: operand on {x.device}, matrix on "
                             f"{t.device}")


def _check_kernel_operands(what: str, kernel: str, x: torch.Tensor,
                           values: torch.Tensor, *index) -> None:
    """Device, dtype and contiguity checks before pointers reach a kernel,
    and ``_cuda.refuse_dtensor`` and ``_cuda.refuse_transforms``."""
    _cuda.refuse_dtensor(what, kernel, x, values, *index)
    _cuda.refuse_transforms(what, kernel, x, values, *index)
    if not x.is_cuda:
        raise ValueError(f"{what}: expected a CUDA tensor, got {x.device}")
    _cuda.suffix(x.dtype)
    _check_same_device(what, x, values, *index)
    if values.dtype != x.dtype:
        raise TypeError(f"{what}: matrix {values.dtype} and operand {x.dtype} "
                        "differ")
    for t in (x, values, *index):
        if not t.is_contiguous():
            raise ValueError(f"{what}: expected contiguous tensors")
    for t in index:
        if t.dtype != torch.int32:
            raise TypeError(f"{what}: indices must be int32, got {t.dtype}")


def _lanes(what: str, xf: torch.Tensor) -> int:
    """The lanes of a launch's operand: 1 for one vector, else the block's
    first axis (1 to ``_cuda.MAX_LANES``)."""
    lanes = xf.shape[0] if xf.dim() == 2 else 1
    if not 1 <= lanes <= _cuda.MAX_LANES:
        raise ValueError(f"{what}: {lanes} lanes (1 to {_cuda.MAX_LANES})")
    return lanes


def dia_spmv_cuda(a: DIAMatrix, x: torch.Tensor) -> torch.Tensor:
    """Launch K3 on a CUDA operand: y (shape[0],) = A·x for x of shape[1]
    entries (any shape, read flat); or, on a (lanes, shape[1]) block, one
    launch for all lanes (what jax.vmap makes of the Pallas kernel: a
    leading grid axis), y (lanes, shape[0]), each lane the bits of its own
    launch: each matrix entry is read once a chunk of lanes, launched by
    ``spmv_lanes_plan``. ``dia_spmv_cuda.launches`` counts launches,
    ``.batched_launches`` those on a block."""
    _cuda.refuse_dtensor("dia_spmv_cuda", "K3", x)
    n_rows, n_cols = a.shape
    xf = _operand(x, n_cols)
    _check_kernel_operands("dia_spmv_cuda", "K3", xf, a.data)
    nd = len(a.offsets)
    if xf.shape[-1] != n_cols or tuple(a.data.shape) != (nd, n_rows):
        raise ValueError(
            f"dia_spmv_cuda: data {tuple(a.data.shape)} with {nd} offsets "
            f"and x of {xf.numel()} entries do not fit shape {a.shape}")
    if a.data.numel() >= 2**31 or n_cols >= 2**31:
        raise ValueError("dia_spmv_cuda: matrix too large for one launch")
    lanes = _lanes("dia_spmv_cuda", xf)
    plan = spmv_lanes_plan("K3", lanes, xf.dtype, n_rows)
    y = torch.empty(xf.shape[:-1] + (n_rows,), dtype=xf.dtype, device=xf.device)
    fn = _cuda.entry("gt_dia_spmv", xf.dtype)
    row_bytes = n_rows * a.data.element_size()
    for c0 in range(0, nd, DIA_MAX_DIAGS_PER_LAUNCH):
        offs = a.offsets[c0:c0 + DIA_MAX_DIAGS_PER_LAUNCH]
        rc = fn(a.data.data_ptr() + c0 * row_bytes, xf.data_ptr(),
                y.data_ptr(), lanes, n_rows, n_cols,
                (ctypes.c_int * len(offs))(*offs), len(offs), int(c0 > 0),
                plan.chunk, *plan.grid, plan.threads, plan.shared_bytes,
                xf.device.index, _cuda.stream_of(xf))
        _cuda.check(rc, "dia_spmv_cuda")
        dia_spmv_cuda.launches += 1
        dia_spmv_cuda.batched_launches += int(xf.dim() == 2)
    return y


dia_spmv_cuda.launches = 0
dia_spmv_cuda.batched_launches = 0


def bsr_spmv_cuda(a: BSRMatrix, x: torch.Tensor) -> torch.Tensor:
    """Launch K4 on a CUDA operand: y (nbr·bs,) = A·x for x of nbc·bs
    entries; or, on a (lanes, nbc·bs) block, one launch for all lanes, y
    (lanes, nbr·bs), each lane the bits of its own launch: each matrix entry
    is read once a chunk of lanes, launched by ``spmv_lanes_plan``.
    ``bsr_spmv_cuda.launches`` counts launches, ``.batched_launches`` those
    on a block."""
    _cuda.refuse_dtensor("bsr_spmv_cuda", "K4", x)
    xf = _operand(x, a.shape[1])
    _check_kernel_operands("bsr_spmv_cuda", "K4", xf, a.data, a.block_cols)
    nbr, k, bs, bs2 = a.data.shape
    if (bs != bs2 or k < 1 or tuple(a.block_cols.shape) != (nbr, k)
            or a.shape[0] != nbr * bs or xf.shape[-1] != a.shape[1]
            or a.shape[1] % bs):
        raise ValueError(
            f"bsr_spmv_cuda: data {tuple(a.data.shape)}, block_cols "
            f"{tuple(a.block_cols.shape)} and x of {xf.numel()} entries do "
            f"not fit shape {a.shape}")
    if a.data.numel() >= 2**31 or xf.numel() >= 2**31:
        raise ValueError("bsr_spmv_cuda: matrix too large for one launch")
    lanes = _lanes("bsr_spmv_cuda", xf)
    plan = spmv_lanes_plan("K4", lanes, xf.dtype, nbr, bs)
    y = torch.empty(xf.shape[:-1] + (nbr * bs,), dtype=xf.dtype, device=xf.device)
    fn = _cuda.entry("gt_bsr_spmv", xf.dtype)
    rc = fn(a.data.data_ptr(), a.block_cols.data_ptr(), xf.data_ptr(),
            y.data_ptr(), lanes, nbr, a.shape[1] // bs, k, bs, plan.chunk,
            *plan.grid, plan.threads, plan.shared_bytes, xf.device.index,
            _cuda.stream_of(xf))
    _cuda.check(rc, "bsr_spmv_cuda")
    bsr_spmv_cuda.launches += 1
    bsr_spmv_cuda.batched_launches += int(xf.dim() == 2)
    return y


bsr_spmv_cuda.launches = 0
bsr_spmv_cuda.batched_launches = 0


def _spmv_lanes(dims, n, x, a):
    """K3's and K4's vmap rule: one call of the routed entry on the lanes'
    (lanes, n_cols) block (one batched launch on the card, the plain
    version on a CPU block)."""
    xb = x.movedim(dims[0], 0).reshape(n, -1).contiguous()
    spmv = dia_spmv_pallas if isinstance(a, DIAMatrix) else bsr_spmv_pallas
    return spmv(a, xb).reshape(n, -1)


class SpmvLanes(torch.autograd.Function):
    """K3's and K4's routed entries under ``torch.func.vmap``:
    ``SpmvLanes.apply(x, a)`` is the product of a (a DIAMatrix or a
    BSRMatrix) with x, and its vmap rule (``_spmv_lanes``, through
    ``_cuda.through_lanes`` without the Function where vmap is the only
    transform) makes one call on the lanes' block: one K3 or K4 launch for
    all lanes on the card, each lane its own launch's bits. No autograd
    rule, as K3 and K4 have none."""

    @staticmethod
    def forward(x, a):
        return (dia_spmv_pallas if isinstance(a, DIAMatrix) else bsr_spmv_pallas)(a, x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, *args):
        return _spmv_lanes(in_dims, info.batch_size, *args), 0


def dia_spmv_pallas(a: DIAMatrix, x: torch.Tensor) -> torch.Tensor:
    """DIA SpMV: the plain version for a CPU operand, K3 for a CUDA one; x
    one operand, or a (lanes, n_cols) block. Under ``torch.func.vmap``, one
    call on the lanes' block (``SpmvLanes``); ``dia_spmv_pallas.block_calls``
    counts calls on a block."""
    _check_same_device("dia_spmv_pallas", x, a.data)
    if _cuda.vmapped(x):
        return _cuda.through_lanes(_spmv_lanes, SpmvLanes, x, a)
    dia_spmv_pallas.block_calls += int(_operand(x, a.shape[1]).dim() == 2)
    if x.device.type == "cpu":
        return dia_spmv(a, x)
    return dia_spmv_cuda(a, x)


def bsr_spmv_pallas(a: BSRMatrix, x: torch.Tensor) -> torch.Tensor:
    """BSR SpMV: the plain version for a CPU operand, K4 for a CUDA one; x
    one operand, or a (lanes, n_cols) block. Under ``torch.func.vmap``, one
    call on the lanes' block (``SpmvLanes``); ``bsr_spmv_pallas.block_calls``
    counts calls on a block."""
    _check_same_device("bsr_spmv_pallas", x, a.data, a.block_cols)
    if _cuda.vmapped(x):
        return _cuda.through_lanes(_spmv_lanes, SpmvLanes, x, a)
    bsr_spmv_pallas.block_calls += int(_operand(x, a.shape[1]).dim() == 2)
    if x.device.type == "cpu":
        return bsr_spmv(a, x)
    return bsr_spmv_cuda(a, x)


dia_spmv_pallas.block_calls = 0
bsr_spmv_pallas.block_calls = 0


def hyb_spmv(a: HYBMatrix, x: torch.Tensor) -> torch.Tensor:
    """y = A x for the hybrid format: the DIA part routed like
    ``dia_spmv_pallas`` plus the gather-ELL residue."""
    y = dia_spmv_pallas(a.dia, x)
    if a.ell is not None:
        y = y + ell_spmv(a.ell, x)
    return y


# ---------------------------------------------------------------------------
# Operator adapters.
# ---------------------------------------------------------------------------


def sparse_operator(a) -> Callable:
    """Wrap any sparse container as a LinearOperator closure over flat
    vectors; an operand on another device than the matrix raises.

    A DTensor x takes the sharded route (``_RankRows``): row-sharded
    (``[Shard(0)]`` on a 1-D mesh, evenly, a square matrix) it gives a flat
    ``[Shard(0)]`` y, each rank applying its rows of the matrix, which every
    rank holds whole; ``[Replicate()]`` is the plain product on the local
    tensor; any other placement raises NotImplementedError. A block of s
    rows of a row-sharded x, a (s, n) DTensor placed ``[Shard(1)]`` under
    ``ops/blas.py:row_apply`` (what gmres_tpu's ``jax.vmap`` makes of the
    operator), takes the rank rows' block form: the collectives of one row
    and one kernel launch for the s rows. So the operator is marked as
    taking it whole (``row_blocks``)."""
    if isinstance(a, CSRMatrix):
        rows = csr_row_ids(a)
        spmv, ref = (lambda x: csr_spmv(a, x, rows=rows)), a.data
    elif isinstance(a, COOMatrix):
        spmv, ref = (lambda x: coo_spmv(a, x)), a.data
    elif isinstance(a, ELLMatrix):
        spmv, ref = (lambda x: ell_spmv(a, x)), a.data
    elif isinstance(a, BSRMatrix):
        spmv, ref = (lambda x: bsr_spmv_pallas(a, x)), a.data
    elif isinstance(a, HYBMatrix):
        spmv, ref = (lambda x: hyb_spmv(a, x)), a.dia.data
    elif isinstance(a, DIAMatrix):
        spmv, ref = (lambda x: dia_spmv_pallas(a, x)), a.data
    else:
        raise TypeError(f"not a sparse matrix: {type(a)}")

    rank_rows: dict = {}

    @row_blocks
    def apply(x: torch.Tensor) -> torch.Tensor:
        _check_same_device("sparse_operator", x, ref)
        if dtensor_of(x) is not None:
            from gmres_tpu_torch.parallel.halo import sharded_apply

            return sharded_apply(x, rank_rows, lambda mesh: _RankRows(a, mesh).form, spmv)
        return spmv(x)

    return apply


# ---------------------------------------------------------------------------
# The sharded route: each rank's rows of a row-sharded x.
# ---------------------------------------------------------------------------


def all_gather_flat(blk: torch.Tensor, group, lanes: bool = False) -> torch.Tensor:
    """The whole flat vector from every rank's flat block over ``group``:
    one explicit all-gather (so a one-rank group issues it too). With
    ``lanes``, ``blk`` is a (s, m) block of s vectors' blocks and the whole
    (s, d·m) block comes back from the same one all-gather."""
    part = blk.T.contiguous() if lanes else blk.reshape(-1).contiguous()
    whole = torch.empty((part.shape[0] * torch.distributed.get_world_size(group),)
                        + tuple(part.shape[1:]), dtype=part.dtype, device=part.device)
    # Not all_gather_single, its newer name: torch 2.11 lacks it.
    torch.distributed.all_gather_into_tensor(whole, part, group=group)
    return whole.T.contiguous() if lanes else whole


def row_block(a, lo: int, hi: int):
    """Rows [lo, hi) of a CSR, COO or ELL matrix, with their global column
    indices (they apply to the whole x)."""
    n_cols = a.shape[1]
    if isinstance(a, CSRMatrix):
        ptr = _host(a.indptr).astype(np.int64)
        s0, s1 = int(ptr[lo]), int(ptr[hi])
        return CSRMatrix(data=a.data[s0:s1], indices=a.indices[s0:s1],
                         indptr=(a.indptr[lo:hi + 1] - int(ptr[lo])).contiguous(),
                         shape=(hi - lo, n_cols))
    if isinstance(a, COOMatrix):
        s0, s1 = np.searchsorted(_host(a.row), (lo, hi))
        return COOMatrix(data=a.data[s0:s1], row=(a.row[s0:s1] - lo).contiguous(),
                         col=a.col[s0:s1], shape=(hi - lo, n_cols))
    return ELLMatrix(data=a.data[lo:hi], cols=a.cols[lo:hi], shape=(hi - lo, n_cols))


class _RankRows:
    """``sparse_operator``'s application to a DTensor x row-sharded on
    ``mesh``, for this rank: y's block is the matrix's rows [lo, hi) (x's
    own range) applied to

    * CSR, COO, ELL and HYB's ELL residue: the whole x, after one all-gather
      of its blocks (``all_gather_flat``; SPAI's application takes the same
      route);
    * DIA and HYB's DIA part: x's block widened by the h = max|offset|
      entries on either side, one halo exchange with the neighbouring ranks
      (``parallel/halo.py:_halo_rows``), then K3 on the rank's rows with its
      offsets shifted by the top halo's width (the plain rows version on a
      CPU block); where h exceeds the block (a band wider than a rank's
      rows) the whole x is gathered instead;
    * BSR: likewise with the block band, h = bs·max|block column − block
      row| over the nonzero blocks, then K4 on the rank's block rows (x's
      block must hold whole block rows).

    So a DIA, a HYB without residue and a BSR whose band fits are one
    exchange and no all-gather an application; the others one all-gather.
    Every rank slices its rows once (``sparse_operator`` keeps this object
    per mesh); the kernels see the rank's plain tensors only.

    ``form`` is the application as a ``parallel/halo.py:BlockSharded``:
    ``local`` on a flat ``[Shard(0)]`` x, and its block form on a (s, n) x
    placed ``[Shard(1)]`` (s rows under ``ops/blas.py:row_apply``), where
    the s rows make the collectives of one row (one exchange of the (s, h)
    band slices each way, or one all-gather of the (s, m) block) and the
    band one lane launch of K3 or K4 on the (s, width) widened block; the
    gathered formats' plain products map over the rows (``torch.func.vmap``).
    Each row gets the bits of its own application."""

    def __init__(self, a, mesh):
        from gmres_tpu_torch.ops.stencil_rdma import _neighbours
        from gmres_tpu_torch.parallel.halo import BlockSharded

        n_rows, n_cols = a.shape
        d = mesh.size()
        if n_rows != n_cols or n_rows % d:
            raise NotImplementedError(
                f"a sparse operator of shape {a.shape} on x row-sharded over {d} "
                "ranks: the sharded route takes a square matrix whose rows divide "
                "evenly over the mesh")
        self.mesh, self.group = mesh, mesh.get_group()
        self.neighbours = _neighbours(self.group)
        m = n_rows // d
        lo = mesh.get_coordinate()[0] * m
        self.m, self.lo = m, lo
        self.halo = 0  # the band's width where it is exchanged
        self.gathers = False
        # The product of the gathered rows with the whole x; the band's rows.
        self.scattered = self.band = None
        if isinstance(a, (CSRMatrix, COOMatrix, ELLMatrix)):
            self.scattered, self.gathers = _rows_product(row_block(a, lo, lo + m)), True
        elif isinstance(a, HYBMatrix):
            if a.ell is not None:
                self.scattered = _rows_product(row_block(a.ell, lo, lo + m))
                self.gathers = True
            self.band = self._dia_rows(a.dia)
        elif isinstance(a, DIAMatrix):
            self.band = self._dia_rows(a)
        else:
            self.band = self._bsr_rows(a)
        self.form = BlockSharded(mesh, lambda xb: self.local(xb.reshape(-1)),
                                 lambda blk: self.local(blk.reshape(blk.shape[0], -1)))

    def _window(self, h: int):
        """(halo width exchanged, shift of x's block in the widened x, widened
        length) for a band of h entries on either side: the exchange where
        the band fits the block, else the whole x (gathered), as where the
        whole x is gathered anyway (a HYB's residue)."""
        if h <= self.m and not self.gathers:
            up, down = self.neighbours
            top = h if up is not None else 0
            return h, top, top + self.m + (h if down is not None else 0)
        self.gathers = True
        return 0, self.lo, self.m * self.mesh.size()

    def _dia_rows(self, a: DIAMatrix) -> DIAMatrix:
        self.halo, shift, width = self._window(max(abs(o) for o in a.offsets))
        return DIAMatrix(data=a.data[:, self.lo:self.lo + self.m].contiguous(),
                         offsets=tuple(o + shift for o in a.offsets),
                         shape=(self.m, width))

    def _bsr_rows(self, a: BSRMatrix) -> BSRMatrix:
        bs = a.block_size
        if self.m % bs:
            raise NotImplementedError(
                f"a BSR operator with {bs}-row blocks on x row-sharded into blocks "
                f"of {self.m}: a rank's block must hold whole block rows")
        cols = _host(a.block_cols).astype(np.int64)
        real = _host(a.data.abs().amax(dim=(2, 3)) > 0)
        rows = np.broadcast_to(np.arange(cols.shape[0])[:, None], cols.shape)
        band = int(np.abs(cols - rows)[real].max()) if real.any() else 0
        self.halo, shift, width = self._window(band * bs)
        b0, b1 = self.lo // bs, (self.lo + self.m) // bs
        local = cols[b0:b1] - (b0 - shift // bs)
        # Padding blocks (all zero) may point anywhere: column 0 of the window.
        local[~real[b0:b1]] = 0
        return BSRMatrix(data=a.data[b0:b1].contiguous(),
                         block_cols=_index(local, a.block_cols.device),
                         shape=(self.m, width))

    def local(self, xb: torch.Tensor) -> torch.Tensor:
        """This rank's y block from its flat x block, or a (s, m) y block from
        a (s, m) block of s rows' x blocks (the collectives of one
        application included)."""
        from gmres_tpu_torch.parallel.halo import _halo_rows

        xb = xb.contiguous()
        lanes = xb.dim() == 2
        whole = all_gather_flat(xb, self.group, lanes) if self.gathers else None
        y = None
        if self.band is not None:
            if whole is not None:
                xw = whole
            elif self.halo:
                top, bottom = _halo_rows(xb, self.group, self.neighbours, xb.dim() - 1,
                                         self.halo)
                parts = [t for t in (top, xb, bottom) if t is not None]
                xw = torch.cat(parts, dim=-1) if len(parts) > 1 else xb
            else:
                xw = xb
            y = (bsr_spmv_pallas if isinstance(self.band, BSRMatrix)
                 else dia_spmv_pallas)(self.band, xw)
        if self.scattered is not None:
            yr = torch.func.vmap(self.scattered)(whole) if lanes else self.scattered(whole)
            y = yr if y is None else y + yr
        return y


def _rows_product(rows) -> Callable:
    """The plain product of a CSR, COO or ELL block of rows (``row_block``)
    with a whole x."""
    if isinstance(rows, CSRMatrix):
        ids = csr_row_ids(rows)
        return lambda x: csr_spmv(rows, x, ids)
    if isinstance(rows, COOMatrix):
        return lambda x: coo_spmv(rows, x)
    return lambda x: ell_spmv(rows, x)
