"""Compact-WY representation of a Householder reflector product.

Counterpart of ``gmres_tpu/ops/householder.py``:

    Q_k = (I − 2p₁p₁ᵀ)···(I − 2p_kp_kᵀ) = I − Pᵀ T P

with P (m+1, n) holding reflector rows and T (m+1, m+1) upper triangular,
so Q v and Qᵀ v are two matmuls each, independent of k. Zero rows of P and
zero rows/cols of T make the representation valid at every prefix
without masking.

In-place updates: ``wy_append`` writes row k of P and column k of T into
the caller's buffers. Row k of P is a zero row before the call, and the
entries of column k below the diagonal come out as −2·(zero rows of T)·c
= 0, so every row and column that was zero beyond k stays zero — the
invariant the unmasked matmuls rely on.

On a row-sharded vector P is a ``[Shard(1)]`` block and T stays plain:
the contractions all-reduce (``ops/blas.py``), the unit vectors are
written on the rank that owns their flat index, and the columns of P are
read with one all-reduce of a vector that is zero off the owning rank
(``ops/flat.py``). The Arnoldi indices 0…m lie in rank 0's block whenever
m + 1 ≤ N²/d; nothing here relies on it.
"""

from __future__ import annotations

import torch

from gmres_tpu_torch.ops.blas import replicate_like, row_combine, row_contract
from gmres_tpu_torch.ops.flat import flat_columns, flat_eye, flat_set


def wy_apply(p: torch.Tensor, t: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Q v = v − Pᵀ(T(P v))."""
    return v - row_combine(t @ row_contract(p, v), p)


def wy_apply_transpose(
    p: torch.Tensor, t: torch.Tensor, v: torch.Tensor
) -> torch.Tensor:
    """Qᵀ v = v − Pᵀ(Tᵀ(P v))."""
    return v - row_combine(t.T @ row_contract(p, v), p)


def wy_basis_vector(p: torch.Tensor, t: torch.Tensor, idx: int) -> torch.Tensor:
    """Q e_idx — the Arnoldi basis vector at flat index idx.

    P e_idx is column idx of P; the JAX version computes it as a masked
    contraction (a TPU layout constraint), which gives the same values,
    since every other product in it is an exact zero."""
    e = flat_set(torch.zeros_like(p[0]), idx, 1)
    pe = flat_columns(p, idx + 1)[:, idx]
    return e - row_combine(t @ pe, p)


def wy_append(
    p: torch.Tensor, t: torch.Tensor, p_new: torch.Tensor, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Append reflector p_new as row k of P and update T, in place.

    Must be called with P still holding zeros at row k (the update term
    uses only rows < k, which zero rows guarantee)."""
    tcol = -2.0 * (t @ row_contract(p, p_new))  # −2·T(P·p_new), (m+1,)
    t[:, k] = tcol
    t[k, k] = 2.0
    p[k] = p_new
    return p, t


def wy_basis(p: torch.Tensor, t: torch.Tensor, m: int) -> torch.Tensor:
    """Explicit orthonormal basis V (m, n_flat): V[i] = Q e_i."""
    pf = p.reshape(p.shape[0], -1)  # (m+1, n)
    pe = flat_columns(p, m)  # P e_i for i < m, (m+1, m)
    eye = flat_eye(m, p[0]).reshape(m, -1)
    return eye - replicate_like((t @ pe).T, pf) @ pf
