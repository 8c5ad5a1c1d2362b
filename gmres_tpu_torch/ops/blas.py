"""Vector (BLAS-1/2) operations on tensors.

Counterpart of ``gmres_tpu/ops/blas.py``. The JAX module routes basis
contractions around XLA:TPU's slow f64 ``dot``; that route has no reason
to exist here, so ``row_contract``/``row_combine`` are plain
``tensordot`` (cuBLAS on the card, which keeps float32 products in full
float32 as long as ``torch.backends.cuda.matmul.allow_tf32`` is False).

Row-sharded vectors (``DTensor`` with ``[Shard(0)]``, see
``parallel/mesh.py``): the reductions here are where a solver's values
cross from the sharded vectors to its small state (Hessenberg column,
Givens rotations, norms, step lengths). Each returns a plain tensor,
all-reduced over the mesh (``as_plain``): DTensor refuses to combine a
plain tensor with a DTensor in a product, and dispatching the solver's
dozens of tiny per-iteration operations through DTensor would cost host
time for nothing. Everything else a solver does is elementwise on the
vectors and stays sharded. On plain tensors nothing changes.
"""

from __future__ import annotations

import torch

if torch.distributed.is_available():
    from torch.distributed.tensor import DTensor, Replicate
else:  # a torch built without distributed: no tensor is a DTensor
    DTensor, Replicate = (), None


def is_dtensor(x) -> bool:
    """True for a ``torch.distributed.tensor.DTensor``."""
    return isinstance(x, DTensor)


def as_plain(t: torch.Tensor) -> torch.Tensor:
    """A plain tensor holding the whole value of ``t``: a DTensor's
    partial sums are all-reduced over its mesh (one collective), a
    replicated DTensor is unwrapped; a plain tensor is returned as is."""
    return t.full_tensor() if is_dtensor(t) else t


def row_contract(rows: torch.Tensor, v: torch.Tensor,
                 conj: bool = False) -> torch.Tensor:
    """Basis contraction (R, *shape) × (*shape) → (R,): rowsᵢ·v, or
    conj(rowsᵢ)·v with ``conj``. For a complex basis that is taken as
    conj(rows·conj(v)): the same products and sums, without materialising
    the conjugate of the whole basis."""
    flat = rows.reshape(rows.shape[0], -1)
    if conj and rows.is_complex():
        return as_plain((flat @ v.reshape(-1).conj()).conj())
    return as_plain(flat @ v.reshape(-1))


def row_combine(coefs: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Linear combination (R, *extra) × (R, *shape) → (*extra, *shape):
    out[e] = Σᵢ coefs[i, e]·rowsᵢ (``tensordot(coefs, rows, dims=([0], [0]))``).
    Communication-free on sharded rows: the coefficients are replicated."""
    if is_dtensor(rows) and not is_dtensor(coefs):
        coefs = DTensor.from_local(
            coefs, rows.device_mesh, [Replicate()] * rows.device_mesh.ndim,
            run_check=False)
    return torch.tensordot(coefs, rows, dims=([0], [0]))


def row_apply(fn, rows: torch.Tensor) -> torch.Tensor:
    """fn on each row of the block (JAX's ``jax.vmap(fn)``): one call, and on
    the card one launch of fn's kernels, per row."""
    return torch.stack([fn(rows[i]) for i in range(rows.shape[0])])


def _svqb(w: torch.Tensor, eps: float):
    """One SVQB pass over the s long rows of w: (q, r) with orthonormal rows
    q and w[b] = Σ_a r[a, b]·q[a] (r = S⁻¹, dense). Directions below
    eps·λ_max are clamped and come out as orthonormalised noise with ~zero
    weight."""
    s = w.shape[0]
    flat = w.reshape(s, -1)
    g = flat.conj() @ flat.T
    d = torch.sqrt(torch.clamp(torch.diagonal(g).real, min=0.0))
    dinv = torch.where(d > 0, 1.0 / torch.where(d > 0, d, torch.ones_like(d)),
                       torch.zeros_like(d))
    gs = g * dinv[:, None] * dinv[None, :]
    # LAPACK refuses a non-finite input, where JAX's eigh returns NaN: the
    # NaN is put back after, without reading the device.
    finite = torch.isfinite(gs).all()
    lam, u = torch.linalg.eigh(torch.where(finite, gs, torch.zeros_like(gs)))
    lam = torch.where(finite, lam, torch.full_like(lam, float("nan")))
    lmax = torch.clamp(lam[-1], min=eps)
    lam_c = torch.maximum(lam, eps * lmax)
    smat = (dinv[:, None] * u) / torch.sqrt(lam_c)[None, :]
    q = torch.tensordot(smat, w, dims=([0], [0]))
    r = (torch.sqrt(lam_c)[:, None] * u.T) * d[None, :]
    return q, r


def _orthonormalize_block(w: torch.Tensor, eps: float):
    """SVQB twice: (q, H) with w[b] = Σ_a H[a, b]·q[a]."""
    q1, r1 = _svqb(w, eps)
    q2, r2 = _svqb(q1, eps)
    return q2, r2 @ r1


def tree_vdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Scalar inner product Σ conj(aᵢ)·bᵢ (0-d tensor)."""
    return as_plain(torch.sum(a.conj() * b))


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
    solver reads all k back from the device at once (and a mesh reduces all
    k in one all-reduce). Each is one ``vdot`` (one read of each operand;
    stacking the operands first would copy them)."""
    return as_plain(torch.stack([torch.vdot(a.reshape(-1), b.reshape(-1))
                                 for a, b in pairs]))
