"""Vector (BLAS-1/2) operations on tensors.

Counterpart of ``gmres_tpu/ops/blas.py``. The JAX module routes basis
contractions around XLA:TPU's slow f64 ``dot``; that route has no reason
to exist here, so ``row_contract``/``row_combine`` are plain
``tensordot`` (cuBLAS on the card, which keeps float32 products in full
float32 as long as ``torch.backends.cuda.matmul.allow_tf32`` is False).
"""

from __future__ import annotations

import torch


def row_contract(rows: torch.Tensor, v: torch.Tensor,
                 conj: bool = False) -> torch.Tensor:
    """Basis contraction (R, *shape) × (*shape) → (R,): rowsᵢ·v."""
    r = rows.conj() if conj else rows
    return r.reshape(r.shape[0], -1) @ v.reshape(-1)


def row_combine(coefs: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Linear combination (R, *extra) × (R, *shape) → (*extra, *shape):
    out[e] = Σᵢ coefs[i, e]·rowsᵢ (``tensordot(coefs, rows, dims=([0], [0]))``)."""
    return torch.tensordot(coefs, rows, dims=([0], [0]))


def tree_vdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Scalar inner product Σ conj(aᵢ)·bᵢ (0-d tensor)."""
    return torch.sum(a.conj() * b)


def tree_norm(a: torch.Tensor) -> torch.Tensor:
    """2-norm ‖a‖₂, real even for complex a."""
    return torch.sqrt(tree_vdot(a, a).real)


def tree_sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a - b


def tree_axpy(alpha: torch.Tensor, x: torch.Tensor,
              y: torch.Tensor) -> torch.Tensor:
    """y + alpha·x."""
    return y + alpha * x


def tree_zeros_like(a: torch.Tensor) -> torch.Tensor:
    return torch.zeros_like(a)


def batched_vdot(pairs) -> torch.Tensor:
    """k inner products Σ conj(aᵢ)·bᵢ stacked into one (k,) tensor, so a
    solver reads all k back from the device at once. Each is one ``vdot``
    (one read of each operand; stacking the operands first would copy
    them)."""
    return torch.stack([torch.vdot(a.reshape(-1), b.reshape(-1))
                        for a, b in pairs])
