"""Lanczos spectral-bound estimation, and the Arnoldi helpers that extend
it to nonsymmetric operators.

Counterpart of ``gmres_tpu/solvers/lanczos.py``: k-step Lanczos
tridiagonalization with the extreme Ritz values as bounds, a cheap
power-iteration λ_max estimate, k-step Arnoldi (CGS2 over a fixed basis
buffer), its Ritz values, and the damped-Jacobi ω and Manteuffel ellipse
interval sized from them.

JAX's ``fori_loop`` becomes a Python loop over device tensors: the
recurrences read nothing back from the device, and Lanczos' breakdown
freezes and pads with ``torch.where`` on the device, as JAX does. The
small eigenproblems are host math, as in JAX, but here always on a
float64 CPU copy of the (k, k) matrix: ``torch.linalg.eigh`` of the
tridiagonal in ``lanczos_bounds`` (one read at the end; its steps,
``lanczos_bounds_steps``, are one lane of a batched solve) and
``np.linalg.eigvals`` of the Hessenberg in ``arnoldi_ritz_values`` (JAX
solves them in the probe's dtype, so float32 bounds may differ in their
last bits).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from gmres_tpu_torch.ops.blas import row_combine, row_contract, rows_like, tree_vdot
from gmres_tpu_torch.solvers.requests import Apply, read_host, run
from gmres_tpu_torch.types import LinearOperator


def lanczos_bounds(
    A: LinearOperator,
    probe: torch.Tensor,
    steps: int = 20,
    rigorous: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Estimate (λ_min, λ_max) of symmetric A by k-step Lanczos, as 0-d
    tensors of the probe's dtype on its device.

    probe: any nonzero start vector (deterministic: no RNG inside).

    The extreme Ritz values are widened by the per-pair residual bound
    β_k·|last eigenvector component|. rigorous=False replaces the widened
    lower bound with the raw smallest Ritz value, an estimate (it may
    exceed the true λ_min) that suits preconditioner intervals.

    Breakdown (β ≤ 16·ε·scale: the invariant subspace is exhausted)
    freezes the recurrence and pads the remaining diagonal with the first
    Rayleigh quotient, which lies inside the spectrum.
    """
    return run(lanczos_bounds_steps(A, probe, steps, rigorous))


def lanczos_bounds_steps(A, probe: torch.Tensor, steps: int = 20, rigorous: bool = True):
    """``lanczos_bounds`` as steps (``solvers/requests.py``): ``steps``
    applications of A, then one read of the tridiagonal and the last β
    together (in a batched solve one read for every lane), whose ``eigh``
    runs on the lane's own float64 CPU copy."""
    dtype, device = probe.dtype, probe.device
    eps = torch.finfo(dtype).eps
    v = probe / torch.sqrt(tree_vdot(probe, probe))
    v_prev = torch.zeros_like(v)
    zero = torch.zeros((), dtype=dtype, device=device)
    alphas = torch.zeros((steps,), dtype=dtype, device=device)
    betas = torch.zeros((steps,), dtype=dtype, device=device)  # i couples i→i+1
    beta_prev, scale = zero, zero
    dead = torch.zeros((), dtype=torch.bool, device=device)
    for i in range(steps):
        w = (yield Apply(A, v)) - beta_prev * v_prev
        alpha = tree_vdot(w, v)
        w = w - alpha * v
        beta = torch.sqrt(tree_vdot(w, w))
        scale = torch.maximum(scale, torch.abs(alpha) + beta)
        stop = dead | (beta <= 16.0 * eps * scale)
        alphas[i] = torch.where(dead, alphas[0], alpha)
        beta_eff = torch.where(stop, zero, beta)
        betas[i] = beta_eff
        v_next = torch.where(stop, torch.zeros_like(v),
                             w / torch.where(beta > 0, beta, torch.ones_like(beta)))
        v_prev, v, beta_prev, dead = v, v_next, beta_eff, stop

    # The (k, k) tridiagonal eigenproblem on a float64 CPU copy.
    host = yield from read_host(torch.cat([alphas, betas, beta_prev.reshape(1)]))
    a64, b64 = host[:steps], host[steps:2 * steps]
    tri = torch.diag(a64) + torch.diag(b64[:-1], 1) + torch.diag(b64[:-1], -1)
    ritz, vecs = torch.linalg.eigh(tri)
    resid = float(host[-1]) * torch.abs(vecs[-1, :])
    if rigorous:
        lo = max(float(ritz[0] - resid[0]), 0.0)
    else:
        lo = float(ritz[0])
    hi = float(ritz[-1] + resid[-1])
    return (torch.tensor(lo, dtype=dtype, device=device),
            torch.tensor(hi, dtype=dtype, device=device))


def power_iteration_bound(
    A: LinearOperator,
    probe: torch.Tensor,
    steps: int = 50,
) -> torch.Tensor:
    """Spectral-radius estimate by power iteration: |Rayleigh quotient| of
    the last iterate (a 0-d tensor)."""
    v = probe / torch.sqrt(tree_vdot(probe, probe))
    for _ in range(steps):
        w = A(v)
        v = w / torch.sqrt(tree_vdot(w, w))
    return torch.abs(tree_vdot(v, A(v)) / tree_vdot(v, v))


def arnoldi_expand(
    A: LinearOperator,
    basis: torch.Tensor,
    hmat: torch.Tensor,
    start: int,
):
    """Continue an Arnoldi(-like) factorization from column ``start``: rows
    [0, start] of ``basis`` must be orthonormal and columns [0, start) of
    ``hmat`` filled; columns [start, steps) are computed by CGS2 over the
    full masked buffer. Returns new (basis, hmat); the inputs are not
    modified."""
    return run(arnoldi_expand_steps(A, basis, hmat, start))


def arnoldi_expand_steps(A, basis, hmat, start: int):
    """``arnoldi_expand`` as steps (``solvers/requests.py``): each
    application of A a request."""
    steps = hmat.shape[1]
    basis, hmat = basis.clone(), hmat.clone()
    for j in range(start, steps):
        w = yield Apply(A, basis[j])
        mask = (torch.arange(steps + 1, device=basis.device) <= j).to(basis.dtype)

        def cgs_pass(w):
            h = row_contract(basis, w, conj=True) * mask
            return h, w - row_combine(h, basis)

        h1, w = cgs_pass(w)
        h2, w = cgs_pass(w)
        # ⟨w, w⟩ is real; for a complex basis torch keeps it complex and
        # refuses the comparison below, so β is taken from the real part and
        # cast back to the basis dtype where it is stored.
        beta = torch.sqrt(tree_vdot(w, w).real)
        hcol = h1 + h2
        hcol[j + 1] += beta.to(basis.dtype)
        basis[j + 1] = w / torch.where(beta > 0, beta, torch.ones_like(beta))
        hmat[:, j] = hcol
    return basis, hmat


def arnoldi_factorization(
    A: LinearOperator,
    probe: torch.Tensor,
    steps: int = 20,
):
    """k-step Arnoldi factorization A·V_k = V_{k+1}·H̄: returns (basis,
    hmat), basis (steps+1, *shape) orthonormal, hmat the (steps+1, steps)
    Hessenberg."""
    return run(arnoldi_factorization_steps(A, probe, steps))


def arnoldi_factorization_steps(A, probe: torch.Tensor, steps: int = 20):
    """``arnoldi_factorization`` as steps (``solvers/requests.py``)."""
    nrm = torch.sqrt(tree_vdot(probe, probe))
    v0 = probe / torch.where(nrm > 0, nrm, torch.ones_like(nrm))
    basis = rows_like(steps + 1, probe)  # [Shard(1)] for a row-sharded probe
    basis[0] = v0
    hmat = torch.zeros((steps + 1, steps), dtype=probe.dtype, device=probe.device)
    return (yield from arnoldi_expand_steps(A, basis, hmat, 0))


def arnoldi_hessenberg(
    A: LinearOperator,
    probe: torch.Tensor,
    steps: int = 20,
) -> torch.Tensor:
    """The (steps+1, steps) Hessenberg of k-step Arnoldi: the nonsymmetric
    extension of ``lanczos_bounds``. Breakdown leaves a zero subdiagonal."""
    return arnoldi_factorization(A, probe, steps)[1]


def arnoldi_ritz_values(
    A: LinearOperator,
    probe: torch.Tensor,
    steps: int = 20,
) -> np.ndarray:
    """Complex Ritz values (a numpy array) of A from k-step Arnoldi; the
    (k, k) eigenproblem is solved on a float64 host copy."""
    h = arnoldi_hessenberg(A, probe, steps).detach().to("cpu", torch.float64)
    return np.linalg.eigvals(h.numpy()[:steps, :steps])


def estimate_jacobi_omega(
    A: LinearOperator,
    probe: torch.Tensor,
    diag: float,
    steps: int = 12,
    band: float = 4.0,
):
    """Damped-Jacobi ω for a smoother on A with constant diagonal ``diag``:
    the ω of a 146-point grid on [0.05, 1.5] that minimises
    max |1 − (ω/diag)·λ| over the Ritz values with Re λ ≥ max Re λ / band
    (the high-frequency band the smoother must contract). Returns (omega,
    ritz); 0.7 when no Ritz value is in the band."""
    ritz = arnoldi_ritz_values(A, probe, steps)
    return jacobi_omega_from_ritz(ritz, diag, band), ritz


def jacobi_omega_from_ritz(ritz, diag: float, band: float = 4.0) -> float:
    """``estimate_jacobi_omega``'s choice from given Ritz values: the ω of a
    146-point grid on [0.05, 1.5] minimising max |1 − (ω/diag)·λ| over those
    with Re λ ≥ max Re λ / band; 0.7 when none is in the band."""
    re_max = float(np.max(ritz.real))
    upper = ritz[ritz.real >= re_max / band]
    if upper.size == 0:  # degenerate probe; fall back to the default
        return 0.7
    grid = np.linspace(0.05, 1.5, 146)
    rho = np.abs(1.0 - np.outer(grid, upper / diag)).max(axis=1)
    return float(grid[int(np.argmin(rho))])


def chebyshev_ellipse_interval(
    ritz,
    band: float | None = 4.0,
    im_safety: float = 1.1,
    re_safety: float = 1.02,
):
    """Manteuffel's ellipse-corrected Chebyshev interval for a complex
    spectrum: the real foci (d − c, d + c) of the ellipse (centre d,
    semi-axes a > b) around the target Ritz values, or None when the region
    is taller than wide (b ≥ 0.95·a) or the interval would touch zero.

    band: target [re_max/band, re_max] (a multigrid smoother); None targets
    the whole spectrum (a coarse solve)."""
    ritz = np.asarray(ritz)
    re_max = float(ritz.real.max()) * re_safety
    if band is None:
        lo = max(float(ritz.real.min()), 0.0) * 0.8
    else:
        lo = re_max / band
    sub = ritz[ritz.real >= lo / re_safety]
    if sub.size == 0 or re_max <= lo:
        return None
    b = float(np.abs(sub.imag).max()) * im_safety
    a = (re_max - lo) / 2.0
    d = (re_max + lo) / 2.0
    if b >= 0.95 * a:
        return None
    c = (a * a - b * b) ** 0.5
    if d - c <= 0.0:
        return None
    return d - c, d + c
