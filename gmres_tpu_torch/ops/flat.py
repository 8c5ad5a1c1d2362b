"""Flat-index (C-order) operations on N-D tensors.

Counterpart of ``gmres_tpu/ops/flat.py``. The JAX module writes each
operation as a mask against a flat-index iota so that it stays
sharding-transparent under jit; an eager single-device tensor can index
its flat view directly, which gives the same values (a masked sum of one
element and zeros is that element exactly).

Row-sharded vectors (a ``[Shard(0)]`` DTensor, and the ``[Shard(1)]``
blocks of ``ops/blas.py:rows_like``) have no flat view across ranks: each
operation here runs on this rank's block, whose first element has the
global flat index ``row offset × row length``. The ones that write (a
mask, an added component, a unit vector) stay local; the ones that read
components into a plain tensor (``flat_get``, ``flat_head``,
``flat_columns``, ``flat_tail_sq``) add the ranks' parts in one
all-reduce, every part but the owner's being exact zeros.
"""

from __future__ import annotations

import torch

from gmres_tpu_torch.ops.blas import as_plain, is_dtensor, mesh_sum, rows_like, shard_offset

if torch.distributed.is_available():
    from torch.distributed.tensor import DTensor
else:  # a torch built without distributed: no tensor is a DTensor
    DTensor = ()


def _flat_block(x: torch.Tensor, lead: int = 0):
    """(this rank's block of x flattened past its ``lead`` leading
    dimensions, the global flat index of the block's first element); x
    itself at offset 0 for a plain tensor."""
    if not is_dtensor(x):
        return x.reshape(*x.shape[:lead], -1), 0
    blk = x.to_local()
    per_row = blk[(0,) * (lead + 1)].numel()
    return blk.reshape(*blk.shape[:lead], -1), shard_offset(x) * per_row


def _wrap(blk: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """This rank's block ``blk`` (shaped like like's local block) as a
    DTensor placed as ``like``."""
    return DTensor.from_local(blk, like.device_mesh, like.placements, run_check=False)


def _window(off: int, numel: int, lo: int, hi: int):
    """The global flat range [a, e) of [lo, hi) that a block holding
    [off, off + numel) owns (a >= e where it owns none)."""
    return max(lo, off), min(hi, off + numel)


def flat_iota(x: torch.Tensor) -> torch.Tensor:
    """C-order flat index of every element, shaped like x (int64)."""
    return torch.arange(x.numel(), device=x.device).reshape(x.shape)


def flat_get(x: torch.Tensor, i: int) -> torch.Tensor:
    """x.ravel()[i] (0-d tensor; one all-reduce on a mesh)."""
    return flat_head(x, i + 1)[i]


def flat_head(x: torch.Tensor, k: int) -> torch.Tensor:
    """x.ravel()[:k], a plain (k,) tensor (one all-reduce on a mesh)."""
    flat, off = _flat_block(x)
    if not is_dtensor(x):
        return flat[:k]
    part = torch.zeros((k,), dtype=flat.dtype, device=flat.device)
    a, e = _window(off, flat.numel(), 0, k)
    if a < e:
        part[a:e] = flat[a - off:e - off]
    return mesh_sum(part, x)


def flat_columns(rows: torch.Tensor, k: int) -> torch.Tensor:
    """Flat components 0…k−1 of each row of a (R, *shape) block: the plain
    (R, k) tensor rows.reshape(R, −1)[:, :k] (one all-reduce on a mesh)."""
    flat, off = _flat_block(rows, lead=1)
    if not is_dtensor(rows):
        return flat[:, :k]
    part = torch.zeros((rows.shape[0], k), dtype=flat.dtype, device=flat.device)
    a, e = _window(off, flat.shape[1], 0, k)
    if a < e:
        part[:, a:e] = flat[:, a - off:e - off]
    return mesh_sum(part, rows)


def flat_tail_sq(x: torch.Tensor, i: int) -> torch.Tensor:
    """Σ of x.ravel()[i:]² (0-d; one all-reduce on a mesh)."""
    if not is_dtensor(x):
        tail = x.reshape(-1)[i:]
        return torch.sum(tail * tail)
    y = mask_ge(x, i)
    return as_plain(torch.sum(y * y))


def flat_set(x: torch.Tensor, i: int, v) -> torch.Tensor:
    """A copy of x with x.ravel()[i] = v."""
    flat, off = _flat_block(x)
    y = flat.clone()
    if 0 <= i - off < y.numel():
        y[i - off] = v
    return _wrap(y.reshape(x.to_local().shape), x) if is_dtensor(x) else y.reshape(x.shape)


def flat_add(x: torch.Tensor, i: int, v) -> torch.Tensor:
    """A copy of x with x.ravel()[i] += v (v a number or a 0-d plain
    tensor, the same on every rank)."""
    flat, off = _flat_block(x)
    y = flat.clone()
    if 0 <= i - off < y.numel():
        y[i - off] += v
    return _wrap(y.reshape(x.to_local().shape), x) if is_dtensor(x) else y.reshape(x.shape)


def mask_lt(x: torch.Tensor, i: int) -> torch.Tensor:
    """Zero every component with flat index >= i (keep the prefix)."""
    y = x.clone()
    y.reshape(-1)[max(i, 0):] = 0
    return y


def mask_ge(x: torch.Tensor, i: int) -> torch.Tensor:
    """Zero every component with flat index < i (keep the suffix)."""
    flat, off = _flat_block(x)
    y = flat.clone()
    y[:min(max(i - off, 0), y.numel())] = 0
    return _wrap(y.reshape(x.to_local().shape), x) if is_dtensor(x) else y.reshape(x.shape)


def flat_embed(vals: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """The vector shaped and placed like ``like`` whose flat components
    0…k−1 are the k ``vals`` (in vals' dtype), zeros elsewhere."""
    k = vals.shape[0]
    if not is_dtensor(like):
        out = torch.zeros((like.numel(),), dtype=vals.dtype, device=vals.device)
        out[:k] = vals
        return out.reshape(like.shape)
    blk, off = _flat_block(like)
    out = torch.zeros((blk.numel(),), dtype=vals.dtype, device=blk.device)
    a, e = _window(off, blk.numel(), 0, k)
    if a < e:
        out[a - off:e - off] = vals[a:e]
    return _wrap(out.reshape(like.to_local().shape), like)


def flat_eye(k: int, like: torch.Tensor, dtype=None) -> torch.Tensor:
    """The k unit vectors e_0…e_{k−1} shaped like ``like``, stacked
    (k, *like.shape), placed as ``ops/blas.py:rows_like`` places a block."""
    out = rows_like(k, like, dtype)
    blk, off = _flat_block(out, lead=1)
    a, e = _window(off, blk.shape[1], 0, k)
    if a < e:
        idx = torch.arange(a, e, device=blk.device)
        blk[idx, idx - off] = 1
    return out


def basis_vector(i: int, shape, dtype, device=None) -> torch.Tensor:
    """Canonical unit vector e_i in C-order flat indexing, shaped."""
    e = torch.zeros(shape, dtype=dtype, device=device)
    e.reshape(-1)[i] = 1
    return e
