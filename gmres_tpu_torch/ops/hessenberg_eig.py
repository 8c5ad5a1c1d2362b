"""Eigenpairs and invariant subspaces of small dense nonsymmetric matrices,
for the deflated GMRES solvers (GMRES-DR, GCRO-DR).

Counterpart of two functions of ``gmres_tpu/ops/hessenberg_eig.py``. That
module writes a Hessenberg reduction and a shifted complex QR iteration in
``lax`` because JAX has no ``eig`` on the TPU; the card has complex dtypes
and PyTorch has ``torch.linalg.eig``, so neither the reduction nor the QR
iteration is ported (the capability, not the workaround):

* ``eig_select`` runs LAPACK's ``geev`` on a float64 (complex128) CPU copy
  of the matrix, as the port's Lanczos and Arnoldi helpers do, and sorts
  the eigenvalues by modulus.
* ``smallest_invariant_subspace`` is JAX's real subspace iteration on A⁻¹
  in plain torch. Its start block cannot be JAX's (``PRNGKey(7)`` has no
  torch counterpart): it comes from one seam, ``_subspace_start``.
"""

from __future__ import annotations

import torch

from gmres_tpu_torch.ops.tri import solve_small


def eig_select(a: torch.Tensor, nvec: int, *, which: str = "smallest"):
    """Sorted eigenvalues and selected unit eigenvectors of a small dense
    matrix.

    a: (m, m) real or complex. nvec: number of eigenvectors. which:
    'smallest' or 'largest' by modulus, the order of the sort (ascending
    for 'smallest') and of the selection.

    Returns (vals, vecs, ok): vals (m,) complex, sorted by |·|; vecs
    (m, nvec) complex unit eigenvectors for vals[:nvec]; ok a 0-d bool
    tensor, True when every value is finite (JAX's says its QR iteration
    converged). All three on a's device, complex of a's precision. The
    eigensolve itself runs on the CPU in complex128, so a CUDA input is
    read back once.
    """
    if which not in ("smallest", "largest"):
        raise ValueError(f"unknown selection '{which}'")
    cdtype = a.dtype if a.is_complex() else a.dtype.to_complex()
    host = a.detach().to("cpu", torch.complex128 if a.is_complex() else torch.float64)
    if not torch.isfinite(host).all():
        # LAPACK refuses a non-finite input; JAX's QR iteration returns
        # non-finite values, and ok is then False.
        host = torch.full_like(host, float("nan"))
        vals, vecs = host.to(torch.complex128).diagonal(), host.to(torch.complex128)
    else:
        vals, vecs = torch.linalg.eig(host)
    order = torch.argsort(vals.abs(), stable=True)
    if which == "largest":
        order = torch.flip(order, (0,))
    vals = vals[order]
    vecs = vecs[:, order[:nvec]]
    nrm = torch.linalg.vector_norm(vecs, dim=0)
    vecs = vecs / torch.where(nrm > 0, nrm, torch.ones_like(nrm))
    ok = torch.isfinite(vals).all() & torch.isfinite(vecs).all()
    return (vals.to(a.device, cdtype), vecs.to(a.device, cdtype), ok.to(a.device))


def _subspace_start(n: int, k: int, dtype: torch.dtype) -> torch.Tensor:
    """The (n, k) standard-normal start block of the subspace iteration, on
    the CPU: a torch.Generator seeded 7 (JAX draws from PRNGKey(7), which
    torch cannot reproduce), drawn in float64 so that every device and
    dtype starts from the same numbers."""
    gen = torch.Generator(device="cpu").manual_seed(7)
    return torch.randn((n, k), generator=gen, dtype=torch.float64).to(dtype)


def smallest_invariant_subspace(a: torch.Tensor, k: int, *, iters: int = 40):
    """Real orthonormal basis (n, k) approximating the invariant subspace of
    the k smallest-|λ| eigenvalues of a real matrix: orthogonal (subspace)
    iteration on A⁻¹, one ``solve_small`` inverse and ``iters`` rounds of a
    small product and a reduced QR, no complex arithmetic.

    It converges at rate (|λ_k|/|λ_{k+1}|)^iters; a complex pair straddling
    the k-cut has no real k-dimensional invariant subspace, and the span
    then mixes the pair (JAX's contract, ``gmres_tpu/ops/hessenberg_eig.py:
    smallest_invariant_subspace``).

    Returns (z, ok): z with orthonormal columns on a's device (zeros when
    ok is False: a singular a or a non-finite iterate); ok a 0-d bool
    tensor.
    """
    n = a.shape[0]
    ai = solve_small(a, torch.eye(n, dtype=a.dtype, device=a.device))
    z, _ = torch.linalg.qr(_subspace_start(n, k, a.dtype).to(a.device))
    for _ in range(iters):
        z, _ = torch.linalg.qr(ai @ z)
    ok = torch.isfinite(z).all()
    return torch.where(ok, z, torch.zeros_like(z)), ok
