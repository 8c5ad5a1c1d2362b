"""Krylov–Schur eigensolver (Stewart 2001) for nonsymmetric operators, on a
complex basis.

Counterpart of ``gmres_tpu/solvers/arnoldi.py``: the same thick restart,

  cycle:  A·V_m = V_m·S + v_{m+1}·sᵀ          (the Arnoldi-like relation)
          S = Z T Zᴴ  ordered so that the ``which``-wanted eigenvalues lead
          truncate: keep V_m·Z[:, :k] and v_{m+1}; the new Rayleigh block is
          [[T_k], [s̃ᵀ]]; expand back to m columns by Arnoldi steps,

with the same restart, convergence and certification rules. The expansion
is the port's ``arnoldi_expand`` (CGS2 over the full masked buffer) on the
probe's device. The ordered Schur form of the (m, m) block is formed on the
host (``ops/hessenberg_eig.py:sorted_schur``: LAPACK's complex Schur form,
then JAX's swap network), where JAX runs its in-jit shifted QR: one read of
the Rayleigh block a cycle.

A real operator is applied to a complex vector as A(re) + i·A(im), both
parts made contiguous first, so a CUDA stencil is 2 launches of K1 per
complex matvec and never sees a complex or strided input.

The solve is a generator of steps (``arnoldi_eigs_steps``,
``solvers/requests.py``), so a batched solve (``solvers/batched.py``) runs
one a lane: the lanes' matvecs are vmapped applications and their Rayleigh
blocks come back in one read, each lane's Schur form formed on its own
host copy.
"""

from __future__ import annotations

import numpy as np
import torch

from gmres_tpu_torch.ops.blas import (
    as_plain,
    complex_from,
    complex_parts,
    row_combine,
    row_op,
    rows_like,
)
from gmres_tpu_torch.ops.hessenberg_eig import schur_eigvec, sorted_schur
from gmres_tpu_torch.solvers.lanczos import arnoldi_expand_steps
from gmres_tpu_torch.solvers.requests import Apply, Read, derived, read_host, rows, run
from gmres_tpu_torch.types import EigResult, LinearOperator, SolverStatus

_WHICH_KEYS = ("LM", "SM", "LR", "SR")


def _sort_key(vals: np.ndarray, which: str) -> np.ndarray:
    """Ascending key: the most wanted eigenvalue has the smallest key."""
    return {
        "LM": lambda v: -np.abs(v),
        "SM": lambda v: np.abs(v),
        "LR": lambda v: -v.real,
        "SR": lambda v: v.real,
    }[which](vals)


def _complex_of(fn):
    def apply(v, *args):
        re, im = complex_parts(v)
        return complex_from(fn(re, *args), fn(im, *args))

    return apply


def complex_apply(A: LinearOperator, is_complex: bool):
    """A on a complex vector: A itself for a complex operator, else
    A(re) + i·A(im) on contiguous parts (a real kernel takes no strided
    view). For a batched solve's operator it is one operator derived from
    it (``requests.derived``): its two applications a complex matvec are
    one vmapped launch each for the lanes that wait together."""
    if is_complex:
        return A
    return derived(A, "complex", _complex_of)


def arnoldi_eigs(
    A: LinearOperator,
    probe: torch.Tensor,
    *,
    nev: int = 6,
    steps: int = 40,
    which: str = "LM",
    tol: float = 1e-8,
    max_restarts: int = 100,
    thick: int | None = None,
) -> EigResult:
    """nev eigenpairs of a (possibly nonsymmetric) operator by Krylov–Schur
    restarted Arnoldi (the arguments of ``gmres_tpu.arnoldi_eigs``).

      A: linear operator (real or complex); a real one is applied to the
        real and imaginary parts apart.
      probe: nonzero start vector; its shape is the problem's, its dtype
        sets the basis's (complex of the probe's precision).
      nev: eigenpairs wanted, nev + 2 ≤ steps.
      steps: Krylov dimension m per cycle.
      which: "LM", "SM", "LR" or "SR".
      tol: absolute per-pair residual ‖A x − λ x‖₂ (x unit norm).
      max_restarts: restart-cycle cap.
      thick: restart size k, default min(max(nev + 1, 2·nev), steps − 2).

    Returns an EigResult with complex ``eigenvalues`` (nev,) most-wanted
    first, complex unit eigenvectors ``x`` (nev, *shape), the certified
    ``residuals``, and ``iterations`` the restart cycles. host_syncs: one
    read of the Rayleigh block a cycle and one of the certified residuals.
    """
    return run(arnoldi_eigs_steps(A, probe, nev=nev, steps=steps, which=which, tol=tol,
                                  max_restarts=max_restarts, thick=thick))


def arnoldi_eigs_steps(A, probe, *, nev=6, steps=40, which="LM", tol=1e-8,
                       max_restarts=100, thick=None):
    """``arnoldi_eigs`` as steps (``solvers/requests.py``): each complex
    matvec one request (two applications of a real A), each cycle one read
    of the Rayleigh block (in a batched solve one read for the lanes that
    wait on it; each lane's Schur form on its own host copy), and the
    certified residuals one block application and one read."""
    if which not in _WHICH_KEYS:
        raise ValueError(f"which must be one of {_WHICH_KEYS}")
    m = steps
    if not 0 < nev <= m - 2:
        raise ValueError(f"need 0 < nev <= steps - 2, got {nev}, {m}")
    k = thick if thick is not None else min(max(nev + 1, 2 * nev), m - 2)
    if not nev <= k <= m - 2:
        raise ValueError(f"need nev <= thick <= steps - 2, got {k}")

    is_complex = probe.is_complex()
    cdtype = probe.dtype if is_complex else probe.dtype.to_complex()
    rdtype = cdtype.to_real()
    dev = probe.device
    shape = tuple(probe.shape)
    a_c = complex_apply(A, is_complex)
    syncs = 0

    def analyze(host):
        """Sorted Schur form of the (m, m) block of the complex128 CPU copy
        ``host``: (t, z, s_row, ys, rest, ok) with S = Z T Zᴴ, s_row =
        host[m, :m]·Z, ys the nev wanted eigenvectors of T (rows) and rest
        the Ritz residual estimates |s_row·y_i| (complex128 / float64,
        CPU)."""
        t, z, ok = sorted_schur(host[:m, :m], lambda d: _sort_key(d, which))
        s_row = host[m, :m] @ z
        if not ok:
            return t, z, s_row, None, torch.full((nev,), float("nan")), ok
        ys = torch.stack([schur_eigvec(t, i) for i in range(nev)])
        return t, z, s_row, ys, (ys @ s_row).abs(), ok

    def truncate(basis, t, z, s_row):
        """Keep V_m·Z[:, :k] and the residual direction; the Rayleigh buffer
        becomes the triangular block with its spike row."""
        new_basis = torch.zeros_like(basis)
        new_basis[:k] = row_combine(z[:, :k].to(dev, cdtype), basis[:m])
        new_basis[k] = basis[m]
        new_smat = torch.zeros((m + 1, m), dtype=torch.complex128)
        new_smat[:k, :k] = t[:k, :k]
        new_smat[k, :k] = s_row[:k]
        return new_basis, new_smat.to(dev, cdtype)

    # A row-sharded probe gives a [Shard(1)] basis whose partial sums are
    # complex. They are all-reduced as they are: gloo's allreduce and NCCL's
    # both take a complex sum through its real view (gloo run on 2 and 4
    # ranks; NCCL between cards not yet).
    basis = rows_like(m + 1, probe, cdtype)
    v0 = probe.to(cdtype)
    nrm = torch.sqrt(as_plain(torch.sum(v0.abs() ** 2)))
    basis[0] = v0 / torch.where(nrm > 0, nrm, torch.ones_like(nrm))
    smat = torch.zeros((m + 1, m), dtype=cdtype, device=dev)
    start, cycles = 0, 0
    while True:
        basis, smat = yield from arnoldi_expand_steps(a_c, basis, smat, start)
        host = yield from read_host(smat)
        t, z, s_row, ys, rest, ok = analyze(host)
        syncs += 1
        cycles += 1
        if not (cycles < max_restarts and bool((rest >= tol).any()) and ok):
            break
        basis, smat = truncate(basis, t, z, s_row)
        start = k

    # Eigenpairs from the last full frame: x_i = V Z y_i.
    if ok:
        zy = (ys @ z.T).T.to(dev, cdtype)  # (m, nev): columns Z y_i
    else:
        zy = torch.full((m, nev), complex("nan"), dtype=cdtype, device=dev)
    x = row_combine(zy, basis[:m])
    axes = tuple(range(1, x.dim()))
    xn = torch.sqrt(as_plain(torch.sum(x.abs() ** 2, dim=axes)))
    x = row_op(torch.div, x, torch.where(xn > 0, xn, torch.ones_like(xn)))
    wanted = torch.diagonal(t)[:nev].to(dev, cdtype)

    ax = yield Apply(rows(a_c), x)
    lam_x = row_op(torch.mul, x, wanted)
    resid = torch.sqrt(as_plain(torch.sum((ax - lam_x).abs() ** 2, dim=axes))).to(rdtype)
    syncs += 1
    if (yield Read((resid < tol).all())):
        status = SolverStatus.CONVERGED
    else:
        status = SolverStatus.MAX_ITERATIONS if ok else SolverStatus.BREAKDOWN
    return EigResult(eigenvalues=wanted, x=x, iterations=cycles, residuals=resid,
                     status=int(status), host_syncs=syncs)
