"""Chebyshev polynomial preconditioners.

Counterpart of ``gmres_tpu/precond/chebyshev.py``:

* ``chebyshev_preconditioner`` — the reference's cbpr2 closed form at
  order 2 (``reference_form=True``), or the order-k semi-iteration, both
  written around the caller's operator A in plain PyTorch (A itself may
  be a kernel: ``poisson_operator`` launches K1 on a CUDA tensor); it
  takes a block of rows of a sharded grid whole where A does
  (``ops/blas.py:row_blocks``).
* ``chebyshev_stencil_preconditioner`` — the semi-iteration specialised to
  a 5-point stencil, routed by device to kernel K2 (a CUDA tensor) or its
  plain version (a CPU tensor). It replaces the TPU routing on
  ``_whole_grid_vmem_ok``. Its ``use_pallas`` takes JAX's values:
  ``"auto"`` and ``"always"`` route by device, and only an explicit
  ``"never"`` takes K2's plain version on any device.
* ``chebyshev_from_lanczos`` — ``chebyshev_preconditioner`` on an interval
  estimated by ``solvers/lanczos.py:lanczos_bounds``.
"""

from __future__ import annotations

from typing import Optional

from gmres_tpu_torch.ops.blas import row_blocks
from gmres_tpu_torch.ops.fused import (
    chebyshev_k_scalars,
    chebyshev_ref_scalars,
    poly_stencil_smoother_pallas,
    poly_stencil_smoother_plain,
)
from gmres_tpu_torch.ops.stencil import POISSON_COEFS
from gmres_tpu_torch.types import LinearOperator, Preconditioner


def chebyshev_preconditioner(
    A: LinearOperator,
    lam_min: float,
    lam_max: float,
    order: int = 2,
    reference_form: bool = True,
) -> Preconditioner:
    """z = M⁻¹(r) approximating A⁻¹ on the spectrum [lam_min, lam_max].

    order=2 with reference_form=True is cbpr2 (z = r/d; z += α(r − A z));
    otherwise the order-k semi-iteration starting at z₀ = 0, with the
    per-step coefficients rounded to r's dtype as in the JAX jnp form."""
    if order == 2 and reference_form:
        d, alpha = chebyshev_ref_scalars(lam_min, lam_max)

        def m_inv(r):
            z = r / d
            return z + alpha * (r - A(z))

        return row_blocks(m_inv, A)

    theta, _, steps = chebyshev_k_scalars(lam_min, lam_max, order)
    pairs = [(steps[2 * s], steps[2 * s + 1]) for s in range(order - 1)]

    def m_inv(r):
        d0 = r / theta
        z = d0
        for a, b in pairs:
            resid = r - A(z)
            d0 = a * d0 + b * resid
            z = z + d0
        return z

    return row_blocks(m_inv, A)


def chebyshev_stencil_preconditioner(
    lam_min: float,
    lam_max: float,
    order: int = 2,
    coefs=POISSON_COEFS,
    use_pallas: str = "auto",
) -> Preconditioner:
    """The order-k semi-iteration on a 5-point stencil operator: K2 on a
    CUDA tensor, the plain recurrence on a CPU tensor. Both apply the
    semi-iteration polynomial at every order, including order 2 (use
    ``chebyshev_preconditioner`` for cbpr2).

    use_pallas: JAX's switch. "auto" (the default) and "always" route by
    the tensor's device as above; "never" applies K2's plain version
    (``poly_stencil_smoother_plain``) on any device, a CUDA tensor
    included. Any other value raises ValueError.

    The returned callable carries its plan as plain data: ``theta`` and
    ``steps`` (the flat [a₀, b₀, a₁, b₁, …] list of ``chebyshev_k_scalars``)
    and ``order``."""
    if use_pallas not in ("auto", "always", "never"):
        raise ValueError(f"unknown use_pallas {use_pallas!r}")
    theta, _, steps = chebyshev_k_scalars(lam_min, lam_max, order)
    coefs = tuple(float(c) for c in coefs)
    smoother = (poly_stencil_smoother_plain if use_pallas == "never"
                else poly_stencil_smoother_pallas)

    def m_inv(r):
        return smoother(r, theta, steps, coefs)

    m_inv.theta = theta
    m_inv.steps = tuple(steps)
    m_inv.order = order
    return m_inv


def chebyshev_from_lanczos(
    A: LinearOperator,
    probe,
    order: int = 2,
    lanczos_steps: int = 20,
    safety: float = 1.05,
    floor: Optional[float] = None,
) -> Preconditioner:
    """``chebyshev_preconditioner`` on bounds estimated by Lanczos: the
    upper end widened by ``safety``, the lower the Ritz estimate
    (``rigorous=False``: the rigorous bound is typically 0 after few
    steps) divided by ``safety`` and held above ``floor`` (default
    hi·1e-8)."""
    from gmres_tpu_torch.solvers.lanczos import lanczos_bounds

    lo, hi = lanczos_bounds(A, probe, steps=lanczos_steps, rigorous=False)
    hi = float(hi) * safety
    if floor is None:
        floor = hi * 1e-8
    lo = max(float(lo) / safety, floor)
    return chebyshev_preconditioner(A, lo, hi, order=order)
