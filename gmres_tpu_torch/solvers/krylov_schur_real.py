"""Krylov–Schur on a real Schur basis (Stewart 2001, the original form).

Counterpart of ``gmres_tpu/solvers/krylov_schur_real.py``, with its
algorithm and division of labour:

  device: real CGS2 Arnoldi expansion of the (m+1, *shape) basis buffer from
    column ``start`` (the port's ``arnoldi_expand``), and the basis
    compression V ← V·Z[:, :k] with the residual vector moved to row k;
  host (numpy and scipy, imported when first called, as in JAX): the real
    sorted Schur form of the (m, m) Rayleigh block with the top-k wanted
    eigenvalues leading (LAPACK gees with a selector; k grows by one rather
    than split a 2×2 block), and the Ritz residual estimates.

The eigenvectors and certified residuals are formed on the device in split
real/imaginary form, two real operator applications a pair (JAX's
``jax.vmap`` over the block is a loop over its rows here). The complex
results are tensors on the probe's device (JAX keeps them in host numpy, as
its runtime cannot hold complex arrays; the card can).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from gmres_tpu_torch.ops.blas import (
    as_plain,
    complex_from,
    row_apply,
    row_combine,
    row_op,
    rows_like,
)
from gmres_tpu_torch.solvers.lanczos import arnoldi_expand
from gmres_tpu_torch.types import EigResult, SolverStatus

_WHICH_KEYS = ("LM", "SM", "LR", "SR")


def _key(vals: np.ndarray, which: str) -> np.ndarray:
    """Descending sort key: larger = more wanted."""
    return {
        "LM": lambda v: np.abs(v),
        "SM": lambda v: -np.abs(v),
        "LR": lambda v: v.real,
        "SR": lambda v: -v.real,
    }[which](vals)


def _sorted_real_schur(s: np.ndarray, k: int, which: str):
    """Real Schur S = Z T Zᵀ with (at least) the top-k wanted eigenvalues in
    the leading block: (t, z, k_eff), k_eff ≤ m − 2 never splitting a 2×2
    block. JAX's ladder of thresholds and margins (gees re-checks the sort
    predicate on eigenvalues recomputed after reordering, so a sharp cut on
    a clustered spectrum can fail; a margin only loosens the cut). Raises
    LinAlgError when every attempt fails."""
    import scipy.linalg as sla

    m = s.shape[0]
    lam = np.linalg.eigvals(s)
    key = np.sort(_key(lam, which))[::-1]
    scale = float(np.max(np.abs(lam))) or 1.0
    for kk in range(k, 0, -1):
        thresh = key[kk - 1]
        for margin in (0.0, 1e-12 * scale, 1e-9 * scale, 1e-6 * scale):
            try:
                t, z, sdim = sla.schur(
                    s, output="real",
                    sort=lambda ar, ai: _key(ar + 1j * ai, which) >= thresh - margin)
            except np.linalg.LinAlgError:
                continue
            if kk <= sdim <= m - 2:
                return t, z, int(sdim)
    raise np.linalg.LinAlgError("no selection threshold produced a valid leading block")


def arnoldi_eigs_real(
    A: Callable,
    probe: torch.Tensor,
    *,
    nev: int = 6,
    steps: int = 40,
    which: str = "LM",
    tol: float = 1e-8,
    max_restarts: int = 100,
    thick: int | None = None,
) -> EigResult:
    """nev eigenpairs of a real (possibly nonsymmetric) operator by
    Krylov–Schur on a real Schur basis: the contract of ``arnoldi_eigs``
    (complex eigenvalues and eigenvectors, most-wanted first, certified
    residuals; the arguments of ``gmres_tpu.arnoldi_eigs_real``) with no
    complex arithmetic on the device.

    host_syncs: one read of the Rayleigh block a cycle and one of the
    certified residuals.
    """
    if which not in _WHICH_KEYS:
        raise ValueError(f"which must be one of {_WHICH_KEYS}")
    m = steps
    if not 0 < nev <= m - 2:
        raise ValueError(f"need 0 < nev <= steps - 2, got {nev}, {m}")
    k0 = thick if thick is not None else min(max(nev + 1, 2 * nev), m - 2)
    if not nev <= k0 <= m - 2:
        raise ValueError(f"need nev <= thick <= steps - 2, got {k0}")
    if probe.is_complex():
        raise ValueError(
            "arnoldi_eigs_real is the REAL-operator route; use "
            "arnoldi_eigs (complex basis) on complex-capable backends")
    shape = tuple(probe.shape)
    rdtype, dev = probe.dtype, probe.device
    cdtype = rdtype.to_complex()
    ndim = len(shape)
    syncs = 0

    nrm = float(torch.sqrt(as_plain(torch.sum(probe * probe))))
    syncs += 1
    basis = rows_like(m + 1, probe)  # [Shard(1)] for a row-sharded probe
    basis[0] = probe / (nrm if nrm > 0 else 1.0)
    hmat_np = np.zeros((m + 1, m), dtype=np.float64)
    start = 0
    status = SolverStatus.MAX_ITERATIONS
    t_np = z_np = None
    cycles = 0
    for cycles in range(1, max_restarts + 1):
        basis, hmat = arnoldi_expand(A, basis, torch.as_tensor(hmat_np, dtype=rdtype,
                                                               device=dev), start)
        hmat_np = hmat.detach().to("cpu", torch.float64).numpy()
        syncs += 1
        s_m = hmat_np[:m, :m]
        if not np.all(np.isfinite(s_m)):
            status = SolverStatus.BREAKDOWN
            break
        try:
            t_np, z_np, k = _sorted_real_schur(s_m, k0, which)
        except np.linalg.LinAlgError:
            status = SolverStatus.BREAKDOWN
            break
        s_row = hmat_np[m, :m] @ z_np
        lam, y = np.linalg.eig(t_np)
        order = np.argsort(-_key(lam, which))
        rest = np.abs(s_row @ y[:, order[:nev]])
        if np.all(rest < tol):
            status = SolverStatus.CONVERGED
            break
        if cycles == max_restarts:
            break
        head = row_combine(torch.as_tensor(z_np[:, :k], dtype=rdtype, device=dev), basis[:m])
        new_basis = torch.zeros_like(basis)
        new_basis[:k] = head
        new_basis[k] = basis[m]
        basis = new_basis
        hmat_np = np.zeros((m + 1, m), dtype=np.float64)
        hmat_np[:k, :k] = t_np[:k, :k]
        hmat_np[k, :k] = s_row[:k]
        start = int(k)

    if t_np is None:  # the first expansion already broke down
        return EigResult(
            eigenvalues=torch.full((nev,), complex("nan"), dtype=cdtype, device=dev),
            x=torch.full((nev,) + shape, complex("nan"), dtype=cdtype, device=dev),
            iterations=cycles,
            residuals=torch.full((nev,), float("nan"), dtype=rdtype, device=dev),
            status=int(SolverStatus.BREAKDOWN), host_syncs=syncs)

    # The nev most-wanted pairs of the last full frame: x_i = V_m (Z y_i).
    lam, y = np.linalg.eig(t_np)
    order = np.argsort(-_key(lam, which))[:nev]
    lam = lam[order]
    zy = z_np @ y[:, order]
    zy = zy / np.linalg.norm(zy, axis=0, keepdims=True)

    def on_dev(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=rdtype, device=dev)

    wr, wi, lr, li = on_dev(zy.real), on_dev(zy.imag), on_dev(lam.real), on_dev(lam.imag)
    xr = row_combine(wr, basis[:m])
    xi = row_combine(wi, basis[:m])
    axr, axi = row_apply(A, xr), row_apply(A, xi)
    rr = axr - (row_op(torch.mul, xr, lr) - row_op(torch.mul, xi, li))
    ri = axi - (row_op(torch.mul, xi, lr) + row_op(torch.mul, xr, li))
    axes = tuple(range(1, ndim + 1))
    res = torch.sqrt(as_plain(torch.sum(rr * rr + ri * ri, dim=axes)))
    # Normalise exactly (the zy columns are unit only up to the basis's
    # orthonormality).
    x = complex_from(xr, xi)
    xn = torch.sqrt(as_plain(torch.sum(x.abs() ** 2, dim=axes)))
    safe = torch.where(xn > 0, xn, torch.ones_like(xn))
    x = row_op(torch.div, x, safe)
    res = res / safe
    syncs += 1
    if status == SolverStatus.CONVERGED and not bool((res < tol).all()):
        # The estimate said converged but the certification disagrees.
        status = SolverStatus.MAX_ITERATIONS
    return EigResult(eigenvalues=torch.as_tensor(lam, dtype=cdtype, device=dev), x=x,
                     iterations=cycles, residuals=res, status=int(status), host_syncs=syncs)
