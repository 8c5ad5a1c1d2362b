"""Order-k polynomial stencil smoothers: host-side coefficients, the plain
PyTorch version and kernel K2.

Counterpart of the order-k part of ``gmres_tpu/ops/fused.py``:

* ``chebyshev_k_scalars``, ``jacobi_k_scalars``, ``chebyshev_ref_scalars``
  — host-side coefficient lists, the same float operations in the same
  order as the JAX module, so they give bit-identical Python floats.
* ``poly_stencil_smoother_pallas`` / ``chebyshev_k_poisson_pallas`` and
  their ``_blocked`` names — kernel K2 (``csrc/chebk.cu``) behind the names
  and data arguments of the Pallas entry points, routed by device: a CPU
  tensor takes the plain recurrence, a CUDA tensor of float32 or float64
  launches K2, any other CUDA dtype raises. The TPU's whole-grid and
  row-blocked kernels exist for VMEM; K2 chooses between its own two paths
  (whole grid in one block's shared memory, or one launch per sweep) from
  the grid's size, so both names reach the same function.

The recurrence (z ≈ A⁻¹r on the 5-point stencil A):

    d₀ = z₀ = r/θ ;  k−1 times:  d ← a·d + b·(r − A z) ;  z ← z + d

with (θ, a, b) rounded to the tensor's dtype, as the JAX jnp form rounds
them (``gmres_tpu/precond/chebyshev.py:90-91``).
"""

from __future__ import annotations

import torch

from gmres_tpu_torch.ops import _cuda
from gmres_tpu_torch.ops.stencil import POISSON_COEFS, _coef_list, stencil_5pt_general

# K2 holds r, z and d of the whole grid in one block's shared memory when
# they fit this budget (of the 227 KB a block may use).
SMEM_BUDGET_BYTES = 200 * 1024


def jacobi_k_scalars(omega: float, center: float, order: int):
    """(θ, steps) expressing an order-k damped-Jacobi sweep in the same
    (θ, per-step [a, b]) form as the Chebyshev semi-iteration:
    θ = c₀/ω and (a, b) = (0, ω/c₀) at every step."""
    step = float(omega) / float(center)
    steps = []
    for _ in range(order - 1):
        steps.extend([0.0, step])
    return 1.0 / step, steps


def chebyshev_k_scalars(lam_min: float, lam_max: float, order: int):
    """Host-side semi-iteration coefficients on [lam_min, lam_max]:
    returns (θ, δ, [ρ'ρ, 2ρ'/δ] per step)."""
    lo, hi = sorted((float(lam_min), float(lam_max)))
    theta = (hi + lo) / 2.0
    delta = (hi - lo) / 2.0
    sigma1 = theta / delta
    rho = 1.0 / sigma1
    steps = []
    for _ in range(order - 1):
        rho_new = 1.0 / (2.0 * sigma1 - rho)
        steps.extend([rho_new * rho, 2.0 * rho_new / delta])
        rho = rho_new
    return theta, delta, steps


def chebyshev_ref_scalars(lam_min: float, lam_max: float):
    """(d, α) of the reference's cbpr2 closed form."""
    lo, hi = sorted((float(lam_min), float(lam_max)))
    c = (hi - lo) / 2.0
    d = (hi + lo) / 2.0
    alpha = 1.0 / d
    beta = (c * alpha / 2.0) ** 2
    return d, 1.0 / (d - beta)


def _rounded(vals, dtype: torch.dtype) -> list[float]:
    """Python floats rounded to ``dtype`` (exact for float64)."""
    return torch.tensor(list(vals), dtype=dtype).tolist()


def poly_stencil_smoother_plain(
    r: torch.Tensor, theta: float, steps, coefs=POISSON_COEFS
) -> torch.Tensor:
    """The plain PyTorch version of K2 (runs on any device)."""
    theta_r = _rounded([theta], r.dtype)[0]
    ab = _rounded(steps, r.dtype)
    c = _coef_list(coefs)
    d = r / theta_r
    z = d
    for s in range(len(ab) // 2):
        az = stencil_5pt_general(z, *c)
        d = ab[2 * s] * d + ab[2 * s + 1] * (r - az)
        z = z + d
    return z


def chebk_cuda(r: torch.Tensor, theta: float, steps,
               coefs=POISSON_COEFS) -> torch.Tensor:
    """Launch K2 on a CUDA (rows, N) grid. ``chebk_cuda.launches`` counts
    kernel launches: 1 on the shared-memory path, one per sweep (at least
    one) otherwise."""
    _cuda.check_grid(r, "chebk_cuda")
    if len(steps) % 2:
        raise ValueError("steps must hold (a, b) pairs")
    nsteps = len(steps) // 2
    lib = _cuda.load()
    whole = (nsteps <= lib.gt_chebk_max_smem_steps()
             and 3 * r.numel() * r.element_size() <= SMEM_BUDGET_BYTES)
    out = torch.empty_like(r)
    scratch = d = None
    if not whole and nsteps >= 2:
        scratch = torch.empty_like(r)
        d = torch.empty_like(r)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    fn = getattr(lib, f"gt_chebk_{_cuda.suffix(r.dtype)}")
    rc = fn(r.data_ptr(), out.data_ptr(), ptr(scratch), ptr(d),
            r.shape[0], r.shape[1], theta,
            _cuda.scalar_array(list(steps), r.dtype), nsteps,
            _cuda.scalar_array(_coef_list(coefs), r.dtype), int(whole),
            r.device.index, _cuda.stream_of(r))
    _cuda.check(rc, "chebk_cuda")
    chebk_cuda.launches += 1 if whole else max(nsteps, 1)
    return out


chebk_cuda.launches = 0


def poly_stencil_smoother_pallas(
    r: torch.Tensor,
    theta: float,
    steps,
    coefs=POISSON_COEFS,
) -> torch.Tensor:
    """Order-k polynomial smoother z ≈ A⁻¹r with the caller's (θ, steps):
    the plain version for a CPU tensor, K2 for a CUDA tensor."""
    if r.device.type == "cpu":
        return poly_stencil_smoother_plain(r, theta, steps, coefs)
    return chebk_cuda(r, theta, steps, coefs)


def chebyshev_k_poisson_pallas(
    r: torch.Tensor,
    order: int,
    lam_min: float,
    lam_max: float,
    coefs=POISSON_COEFS,
) -> torch.Tensor:
    """z ≈ A⁻¹r by the order-k Chebyshev semi-iteration on
    [lam_min, lam_max], routed like ``poly_stencil_smoother_pallas``."""
    theta, _, steps = chebyshev_k_scalars(lam_min, lam_max, order)
    return poly_stencil_smoother_pallas(r, theta, steps, coefs)


poly_stencil_smoother_pallas_blocked = poly_stencil_smoother_pallas
chebyshev_k_poisson_pallas_blocked = chebyshev_k_poisson_pallas


def chebyshev_blocked_feasible(n: int, order: int) -> bool:
    """True iff K2 can take an (n, n) grid at this order. The TPU version
    asks whether a VMEM row tiling exists; K2 covers every grid that fits
    one launch, at every order."""
    return 1 <= n <= 65535 * 8 and n * n < 2**31 and order >= 1
