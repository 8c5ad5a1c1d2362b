"""GMRES-polynomial preconditioning (Loe & Morgan 2021 style).

Counterpart of ``gmres_tpu/precond/polynomial.py``. The degree-d GMRES
residual polynomial's roots are the harmonic Ritz values of A, and
s(z) = (1 − Π(1 − z/θᵢ))/z approximates A⁻¹ over A's actual spectrum,
complex parts and all. Setup: one d-step Arnoldi (``solvers/lanczos.py:
arnoldi_hessenberg``) and a (d, d) harmonic Ritz eigensolve in host numpy,
as in JAX; the roots are ordered by the modified Leja rule with conjugate
pairs adjacent, and each pair is fused into a real quadratic segment:

    single θ:      y += w/θ ;              w ← w − (1/θ)·A w
    pair (θ, θ̄):  y += c1·w − c2·A w ;   w ← w − c1·A w + c2·A(A w)

with c1 = 2·Re θ/|θ|², c2 = 1/|θ|². An application is d operator
applications and no reduction: on a CUDA tensor with the stencil operators
of ``models/`` it launches K1 and nothing else. The degree must grow like
1/h on grid operators: degree 24 converges at 64² and diverges at 256².
"""

from __future__ import annotations

import numpy as np
import torch

from gmres_tpu_torch.types import LinearOperator, Preconditioner


def _modified_leja(roots):
    """Order complex roots by the modified Leja rule (greedy
    max-product-of-distances, from the largest modulus), keeping conjugate
    pairs adjacent. Host-side numpy, at setup."""
    pts = list(roots)
    ordered = []
    cur = max(range(len(pts)), key=lambda i: abs(pts[i]))
    while pts:
        ordered.append(pts.pop(cur))
        last = ordered[-1]
        if abs(last.imag) > 1e-14 * max(abs(last), 1.0):
            # the conjugate next, for the real-quadratic fusion
            j = min(range(len(pts)), key=lambda i: abs(pts[i] - np.conj(last)))
            ordered.append(pts.pop(j))
        if not pts:
            break
        # next: the root maximising the product of distances to those
        # chosen (a sum of logs, for overflow)
        logs = [sum(np.log(max(abs(p - q), 1e-300)) for q in ordered)
                for p in pts]
        cur = int(np.argmax(logs))
    return ordered


def harmonic_ritz_values(A: LinearOperator, probe: torch.Tensor, degree: int):
    """Harmonic Ritz values of A from a degree-step Arnoldi factorisation:
    the roots of the degree-``degree`` GMRES residual polynomial (a numpy
    array; the small eigensolve on a float64 host copy)."""
    from gmres_tpu_torch.solvers.lanczos import arnoldi_hessenberg

    h = arnoldi_hessenberg(A, probe, degree).detach().cpu().numpy()
    hm = h[:degree, :degree]
    h2 = float(h[degree, degree - 1]) ** 2
    e = np.zeros(degree)
    e[-1] = 1.0
    f = np.linalg.solve(hm.conj().T, e)
    return np.linalg.eigvals(hm + h2 * np.outer(f, e))


def gmres_polynomial_preconditioner(
    A: LinearOperator,
    probe: torch.Tensor,
    degree: int = 8,
) -> Preconditioner:
    """M ≈ A⁻¹ as the degree-``degree`` GMRES polynomial of A.

    probe: a representative vector (e.g. the right-hand side) seeding the
    Arnoldi space whose harmonic Ritz values become the roots. The returned
    callable applies A ``degree`` times and reduces nothing; it carries
    ``roots`` (numpy, Leja order) and ``degree``. A root pair straddling
    zero makes the polynomial explode, which shows as divergence."""
    roots = _modified_leja(harmonic_ritz_values(A, probe, degree))

    # (is_pair, c1, c2) segments, in Leja order.
    segments = []
    i = 0
    while i < len(roots):
        th = roots[i]
        if abs(th.imag) > 1e-14 * max(abs(th), 1.0):
            mod2 = float(abs(th) ** 2)
            segments.append((True, 2.0 * float(th.real) / mod2, 1.0 / mod2))
            i += 2
        else:
            segments.append((False, 1.0 / float(th.real), 0.0))
            i += 1

    def m_inv(r: torch.Tensor) -> torch.Tensor:
        w = r
        y = torch.zeros_like(r)
        for is_pair, c1, c2 in segments:
            aw = A(w)
            if is_pair:
                y = y + c1 * w - c2 * aw
                w = w - c1 * aw + c2 * A(aw)
            else:
                y = y + c1 * w
                w = w - c1 * aw
        return y

    m_inv.roots = np.asarray(roots)
    m_inv.degree = degree
    return m_inv
