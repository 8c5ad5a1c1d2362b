"""Flat-index (C-order) operations on N-D tensors.

Counterpart of ``gmres_tpu/ops/flat.py``. The JAX module writes each
operation as a mask against a flat-index iota so that it stays
sharding-transparent under jit; an eager single-device tensor can index
its flat view directly, which gives the same values (a masked sum of one
element and zeros is that element exactly).
"""

from __future__ import annotations

import torch


def flat_iota(x: torch.Tensor) -> torch.Tensor:
    """C-order flat index of every element, shaped like x (int64)."""
    return torch.arange(x.numel(), device=x.device).reshape(x.shape)


def flat_get(x: torch.Tensor, i: int) -> torch.Tensor:
    """x.ravel()[i] (0-d tensor)."""
    return x.reshape(-1)[i]


def flat_set(x: torch.Tensor, i: int, v) -> torch.Tensor:
    """A copy of x with x.ravel()[i] = v."""
    y = x.clone()
    y.reshape(-1)[i] = v
    return y


def flat_add(x: torch.Tensor, i: int, v) -> torch.Tensor:
    """A copy of x with x.ravel()[i] += v."""
    y = x.clone()
    y.reshape(-1)[i] += v
    return y


def mask_lt(x: torch.Tensor, i: int) -> torch.Tensor:
    """Zero every component with flat index >= i (keep the prefix)."""
    y = x.clone()
    y.reshape(-1)[max(i, 0):] = 0
    return y


def mask_ge(x: torch.Tensor, i: int) -> torch.Tensor:
    """Zero every component with flat index < i (keep the suffix)."""
    y = x.clone()
    y.reshape(-1)[:max(i, 0)] = 0
    return y


def basis_vector(i: int, shape, dtype, device=None) -> torch.Tensor:
    """Canonical unit vector e_i in C-order flat indexing, shaped."""
    e = torch.zeros(shape, dtype=dtype, device=device)
    e.reshape(-1)[i] = 1
    return e
