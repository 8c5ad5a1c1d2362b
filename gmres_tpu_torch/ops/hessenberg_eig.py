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

Krylov–Schur (``solvers/arnoldi.py``) needs the ordered complex Schur form
of its (m, m) Rayleigh block. JAX computes it in-jit (Hessenberg reduction,
shifted QR, then ``schur_sort``); here ``sorted_schur`` takes LAPACK's
complex Schur form (``scipy.linalg.schur``, imported when first called) of
a complex128 CPU copy and reorders it with JAX's own swap network,
``schur_sort``, so the wanted order and its ties are JAX's. ``schur_eigvec``
is JAX's masked back-substitution. All three are plain CPU functions on
complex128 tensors: the matrices are at most a few dozen wide.
"""

from __future__ import annotations

import numpy as np
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


def schur_sort(t: torch.Tensor, q: torch.Tensor, key: torch.Tensor):
    """Reorder a complex Schur form so that the diagonal appears in ascending
    ``key`` order (key: (m,) real, computed by the caller from diag(t)).

    JAX's network of adjacent swaps (``gmres_tpu/ops/hessenberg_eig.py:
    schur_sort``, LAPACK ztrexc-style): pass s visits j = 0 … m−2−s; where
    key[j] > key[j+1] the block [[a, c], [0, d]] is rotated by the unitary G
    whose first column is the unit eigenvector (c, d − a) of d, which swaps
    a and d; the keys ride along. Returns (t, q) as new complex128 CPU
    tensors with T' = Gᴴ T G and Q' = Q G over all swaps.
    """
    t = t.detach().to("cpu", torch.complex128).numpy().copy()
    q = q.detach().to("cpu", torch.complex128).numpy().copy()
    key = key.detach().to("cpu", torch.float64).numpy().copy()
    m = t.shape[0]
    for s in range(m - 1):
        for j in range(m - 1 - s):
            if key[j] > key[j + 1]:
                y1, y2 = t[j, j + 1], t[j + 1, j + 1] - t[j, j]
                nrm = np.sqrt(abs(y1) ** 2 + abs(y2) ** 2)
                if nrm > 0:
                    g11, g21 = y1 / nrm, y2 / nrm
                    g = np.array([[g11, -np.conj(g21)], [g21, np.conj(g11)]])
                    # Rows j, j+1 of T ← Gᴴ T (zero left of column j); columns
                    # j, j+1 of T (zero below row j+1) and of Q ← · G.
                    t[j:j + 2, j:] = g.conj().T @ t[j:j + 2, j:]
                    t[:j + 2, j:j + 2] = t[:j + 2, j:j + 2] @ g
                    q[:, j:j + 2] = q[:, j:j + 2] @ g
                key[j], key[j + 1] = key[j + 1], key[j]
            t[j + 1, j] = 0.0
    return torch.from_numpy(t), torch.from_numpy(q)


def schur_eigvec(t: torch.Tensor, i: int) -> torch.Tensor:
    """Unit eigenvector of the upper-triangular T for its i-th diagonal
    eigenvalue: (T − t_ii I) y = 0 with y_i = 1 and y_j = 0 for j > i, by
    back-substitution; a pivot below ε·(‖T‖_F + 1) is replaced by that value
    (LAPACK ztrevc's perturbation; JAX's rule). Complex128, CPU."""
    t = t.detach().to("cpu", torch.complex128).numpy()
    m = t.shape[0]
    lam = t[i, i]
    floor = np.finfo(np.float64).eps * (np.sqrt(np.sum(np.abs(t) ** 2)) + 1.0)
    y = np.zeros((m,), np.complex128)
    y[i] = 1.0
    for j in range(i - 1, -1, -1):
        den = t[j, j] - lam
        if abs(den) < floor:
            den = floor
        y[j] = -np.sum(t[j, j + 1:] * y[j + 1:]) / den
    return torch.from_numpy(y / np.linalg.norm(y))


def sorted_schur(s: torch.Tensor, key_fn):
    """The ordered complex Schur form S = Z T Zᴴ of a small square matrix:
    LAPACK's (``scipy.linalg.schur(…, output="complex")``) of a complex128
    CPU copy, reordered by ``schur_sort`` so that ``key_fn(diag(T))`` (a real
    numpy array) ascends. Returns (t, z, ok): complex128 CPU tensors, and ok
    False when LAPACK failed or S is not finite (t and z are then NaN)."""
    import scipy.linalg as sla

    host = s.detach().to("cpu", torch.complex128).numpy()
    nan = torch.full(host.shape, complex("nan"), dtype=torch.complex128)
    if not np.all(np.isfinite(host)):
        return nan, nan, False
    try:
        t, z = sla.schur(host, output="complex")
    except (np.linalg.LinAlgError, ValueError):
        return nan, nan, False
    key = torch.from_numpy(np.array(key_fn(np.diagonal(t)), np.float64))
    t, z = schur_sort(torch.from_numpy(t), torch.from_numpy(z), key)
    return t, z, True
