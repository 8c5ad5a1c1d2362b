"""Randomized Nyström preconditioner (Frangella, Tropp, Udell, SIMAX 2023).

Counterpart of ``gmres_tpu/precond/nystrom.py``: a rank-r Nyström
approximation Â = U diag(λ̂) Uᵀ of the SPD A from one sketch A·Ω (with
``power_iters`` passes of subspace iteration first), and

    P⁻¹ = (λ̂_r + μ)·U (diag(λ̂) + μ)⁻¹ Uᵀ + (I − U Uᵀ).

The sketch's long rows live on the operand's device: A is applied to each of
the r rows in turn (JAX's ``jax.vmap``), the block is orthonormalised by the
port's SVQB (``ops/blas.py:_orthonormalize_block``), and the
triangular solve and combinations are device products. The (r, r) core's
Cholesky factor and the eigh of the (r, r) Gram run on float64 CPU copies
(two reads of the device). The Gaussian sketch cannot be JAX's (``PRNGKey``
draws have no torch counterpart): it comes from one seam, ``_sketch``.
Applying P⁻¹ is two (r, n) contractions and elementwise work.

On a row-sharded operand the sketch's rows are sharded as a block of rows
is (``[Shard(1)]``, each rank drawing the whole sketch and keeping its own
rows: ``ops/blas.py:shard_rows_like``), A is applied to each row on the
mesh, the (r, r) core and Gram are one all-reduce each before their host
factorisations, and B = Y C⁻ᵀ is solved on each rank's columns. U is kept
so; a preconditioner built on a plain x_like places its U on a sharded
r's mesh when first applied there. An application on a sharded r is one
all-reduce (the (r,) contraction Uᵀr) and local work.
"""

from __future__ import annotations

import torch

from gmres_tpu_torch.ops.blas import (
    _orthonormalize_block,
    as_plain,
    gram,
    is_dtensor,
    on_local,
    per_mesh,
    refuse_row_block,
    row_apply,
    row_combine,
    row_contract,
    shard_rows_like,
)
from gmres_tpu_torch.types import LinearOperator


def _sketch(rank: int, shape, dtype, device, key) -> torch.Tensor:
    """The (rank, *shape) standard-normal sketch Ω: a CPU torch.Generator
    seeded ``key`` (an int, default 0; JAX takes a PRNG key), drawn in
    float64 so every device and dtype sketches with the same numbers."""
    gen = torch.Generator(device="cpu").manual_seed(int(key))
    return torch.randn((rank,) + tuple(shape), generator=gen,
                       dtype=torch.float64).to(device, dtype)


def nystrom_preconditioner(
    A: LinearOperator,
    x_like: torch.Tensor,
    rank: int = 20,
    mu: float = 0.0,
    power_iters: int = 1,
    key=None,
):
    """Build the rank-``rank`` randomized Nyström preconditioner (the
    arguments of ``gmres_tpu.nystrom_preconditioner``; ``key`` is an int
    seed, default 0). x_like gives the operand's shape, dtype and device.

    Returns (preconditioner, eigenvalues): the SPD callable P⁻¹ and the
    (rank,) Nyström eigenvalue estimates λ̂, largest first.
    """
    shape = tuple(x_like.shape)
    dtype, dev = x_like.dtype, x_like.device
    eps = float(torch.finfo(dtype).eps)
    omega = _sketch(rank, shape, dtype, dev, 0 if key is None else key)
    omega = shard_rows_like(omega, x_like)
    omega, _ = _orthonormalize_block(omega, eps)
    for _ in range(power_iters):
        omega, _ = _orthonormalize_block(row_apply(A, omega), eps)
    y = row_apply(A, omega)  # the r matvecs
    # Shifted core (FTU Alg. 2.1): ν absorbs the roundoff of A·Ω so the
    # Cholesky stays positive.
    nu = (rank ** 0.5) * eps * torch.sqrt(as_plain(torch.sum(y * y)))
    y_nu = y + nu * omega
    yflat = y_nu.reshape(rank, -1)
    core = gram(omega, y_nu)
    core = (0.5 * (core + core.T)).detach().to("cpu", torch.float64)
    c = torch.linalg.cholesky(core)
    # B = Y C⁻ᵀ: the rows of C Bᵀ = Yᵀ, solved on the device (on each
    # rank's columns of a sharded Y: the solve mixes rows only).
    bflat = on_local(lambda t: torch.linalg.solve_triangular(
        c.to(dev, dtype), t, upper=False), yflat)
    g = gram(bflat, bflat).detach().to("cpu", torch.float64)
    sig2, v = torch.linalg.eigh(0.5 * (g + g.T))  # ascending
    sig2 = torch.clamp(torch.flip(sig2, (0,)), min=0.0)  # descending
    v = torch.flip(v, (1,))
    nu_h = float(nu)
    lam_hat = torch.clamp(sig2 - nu_h, min=0.0)
    sig_inv = torch.where(sig2 > 0, 1.0 / torch.sqrt(torch.where(sig2 > 0, sig2,
                                                                 torch.ones_like(sig2))),
                          torch.zeros_like(sig2))
    u = on_local(lambda t: (v * sig_inv[None, :]).T.to(dev, dtype) @ t,
                 bflat).reshape((rank,) + shape)
    # The floor keeps P SPD at mu = 0 with a rank-deficient sketch.
    mu_v = max(float(mu), eps * max(float(lam_hat[0]), 1.0))
    scale = float(lam_hat[-1]) + mu_v
    ratio = (scale / (lam_hat + mu_v)).to(dev, dtype)
    lam_hat = lam_hat.to(dev, dtype)
    uflat = u.reshape(rank, -1)
    placed = {}

    def apply(rvec: torch.Tensor) -> torch.Tensor:
        # Not marked by row_blocks: reductions over the mesh (ROADMAP queue 2).
        refuse_row_block("the Nyström application", rvec)
        if is_dtensor(rvec):
            u_r = per_mesh(placed, rvec.device_mesh,
                           lambda _: u if is_dtensor(u) else shard_rows_like(u, rvec))
            cu = row_contract(u_r, rvec)
            return rvec + row_combine(ratio * cu - cu, u_r)
        cu = uflat @ rvec.reshape(-1)
        return rvec + ((ratio * cu - cu) @ uflat).reshape(rvec.shape)

    return apply, lam_hat
