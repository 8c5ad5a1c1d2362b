"""Fused solver kernels: the order-k polynomial stencil smoothers (K2), the
fused cbpr2 application (K5) and the fused CG update and axpy-dot (K7),
each beside its plain PyTorch version.

Counterpart of ``gmres_tpu/ops/fused.py``. Order-k smoothers:

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

The per-shard kernels of the distributed path, routed the same way (a CPU
tensor takes the plain version, a CUDA tensor of float32 or float64 its
kernel, any other CUDA dtype raises):

* ``chebyshev_poisson_fused`` — K5 (``csrc/cheb2_fused.cu``): cbpr2 as one
  stencil pass over a (rows, N) block with explicit halo rows,
  z = r·(1/d) + α(r − A(r)·(1/d)), using A(r/d) = A(r)/d.
* ``cg_fused_update`` and ``axpy_dot`` — K7 (``csrc/cg_fused.cu``):
  x+αp, r−α·ap and ‖r−α·ap‖², or y+αx and (y+αx)·z, in one pass. The
  elementwise work is in the input dtype; the products and the sum are
  float32, and the sum is the LOCAL partial (a caller on a mesh
  all-reduces it), as in the JAX kernels. No solver calls them, as in
  JAX: the CG of ``solvers/cg.py`` keeps the JAX solver's operations.
"""

from __future__ import annotations

import torch

from gmres_tpu_torch.ops import _cuda
from gmres_tpu_torch.ops.stencil import (
    POISSON_COEFS,
    _coef_list,
    _halo_row,
    stencil_5pt_general,
    stencil_5pt_halo,
)

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


# ---------------------------------------------------------------------------
# K5: the fused cbpr2 application with halo rows.
# ---------------------------------------------------------------------------


def _cheb2_scalars(d: float, alpha: float, coefs, dtype) -> list[float]:
    """[1/d, α, c0, cw, ce, cs, cn] rounded to ``dtype`` as the JAX kernel
    holds them: d, α and the coefficients in the dtype, 1/d divided there."""
    d_r, alpha_r, *c = _rounded([d, alpha, *_coef_list(coefs)], dtype)
    return _rounded([1.0 / d_r], dtype) + [alpha_r] + c


def chebyshev_poisson_fused_plain(r, top, bottom, d, alpha,
                                  coefs=POISSON_COEFS) -> torch.Tensor:
    """The plain PyTorch version of K5, in the JAX kernel's operation order
    (``_cheb_kernel``): z = r·(1/d) + α(r − A(r)·(1/d))."""
    inv_d, alpha_r, *c = _cheb2_scalars(d, alpha, coefs, r.dtype)
    zero = torch.zeros((1, r.shape[1]), dtype=r.dtype, device=r.device)
    top = zero if top is None else top.reshape(1, -1)
    bottom = zero if bottom is None else bottom.reshape(1, -1)
    ar = stencil_5pt_halo(r, top, bottom, c)
    return r * inv_d + alpha_r * (r - ar * inv_d)


def cheb2_cuda(r, top, bottom, d, alpha, coefs=POISSON_COEFS) -> torch.Tensor:
    """Launch K5 on a CUDA (rows, N) block; ``top``/``bottom`` are the halo
    rows, None for a zero row. ``cheb2_cuda.launches`` counts launches."""
    _cuda.check_grid(r, "cheb2_cuda")
    top_p = _halo_row(top, r, "cheb2_cuda")
    bot_p = _halo_row(bottom, r, "cheb2_cuda")
    scal = _cheb2_scalars(d, alpha, coefs, r.dtype)
    z = torch.empty_like(r)
    fn = getattr(_cuda.load(), f"gt_cheb2_{_cuda.suffix(r.dtype)}")
    rc = fn(r.data_ptr(), top_p, bot_p, z.data_ptr(), r.shape[0], r.shape[1],
            *scal, r.device.index, _cuda.stream_of(r))
    _cuda.check(rc, "cheb2_cuda")
    cheb2_cuda.launches += 1
    return z


cheb2_cuda.launches = 0


def chebyshev_poisson_fused(r, top, bottom, d, alpha,
                            coefs=POISSON_COEFS) -> torch.Tensor:
    """Degree-2 Chebyshev (cbpr2) application on a (rows, N) block with
    (N,) or (1, N) halo rows (zeros at the physical boundary): the plain
    version for a CPU tensor, K5 for a CUDA tensor."""
    if r.device.type == "cpu":
        return chebyshev_poisson_fused_plain(r, top, bottom, d, alpha, coefs)
    return cheb2_cuda(r, top, bottom, d, alpha, coefs)


# ---------------------------------------------------------------------------
# K7: fused CG update and axpy-dot.
# ---------------------------------------------------------------------------


def _scalar(alpha, like: torch.Tensor) -> torch.Tensor:
    """α as a 0-d tensor of ``like``'s dtype on its device (the JAX
    kernels' ``jnp.asarray(alpha, dtype=x.dtype)``)."""
    return torch.as_tensor(alpha, dtype=like.dtype, device=like.device)


def cg_fused_update_plain(x, r, p, ap, alpha):
    """The plain PyTorch version of K7a: (x+αp, r−α·ap, Σ f32(r−α·ap)²)."""
    a = _scalar(alpha, x)
    rn = r - a * ap
    rf = rn.to(torch.float32)
    return x + a * p, rn, torch.sum(rf * rf)


def axpy_dot_plain(alpha, x, y, z):
    """The plain PyTorch version of K7b: (y+αx, Σ f32(y+αx)·f32(z))."""
    yn = y + _scalar(alpha, x) * x
    return yn, torch.sum(yn.to(torch.float32) * z.to(torch.float32))


def _check_vectors(what: str, *ts: torch.Tensor) -> None:
    for t in ts:
        if not t.is_cuda:
            raise ValueError(f"{what}: expected CUDA tensors, got {t.device}")
        if (t.shape != ts[0].shape or t.dtype != ts[0].dtype
                or t.device != ts[0].device):
            raise ValueError(f"{what}: operands differ in shape, dtype or device")
        if not t.is_contiguous():
            raise ValueError(f"{what}: expected contiguous tensors")
    _cuda.suffix(ts[0].dtype)
    if ts[0].numel() >= 2**31:
        raise ValueError(f"{what}: {ts[0].numel()} elements too many for one launch")


def _reduce_out(lib, n: int, device):
    """The float32 per-block partials and the 0-d float32 sum of a K7 call."""
    partial = torch.empty(lib.gt_fused_reduce_blocks(n), dtype=torch.float32,
                          device=device)
    return partial, torch.empty((), dtype=torch.float32, device=device)


def cg_fused_update_cuda(x, r, p, ap, alpha):
    """Launch K7a (the pass and its one-block sum of the partials) on CUDA
    tensors; ``cg_fused_update_cuda.launches`` counts calls."""
    _check_vectors("cg_fused_update_cuda", x, r, p, ap)
    lib = _cuda.load()
    a = _scalar(alpha, x)
    xo, ro = torch.empty_like(x), torch.empty_like(r)
    partial, rsq = _reduce_out(lib, x.numel(), x.device)
    fn = getattr(lib, f"gt_cg_update_{_cuda.suffix(x.dtype)}")
    rc = fn(x.data_ptr(), r.data_ptr(), p.data_ptr(), ap.data_ptr(),
            a.data_ptr(), xo.data_ptr(), ro.data_ptr(), partial.data_ptr(),
            rsq.data_ptr(), x.numel(), partial.numel(), x.device.index,
            _cuda.stream_of(x))
    _cuda.check(rc, "cg_fused_update_cuda")
    cg_fused_update_cuda.launches += 1
    return xo, ro, rsq


cg_fused_update_cuda.launches = 0


def axpy_dot_cuda(alpha, x, y, z):
    """Launch K7b (the pass and its one-block sum of the partials) on CUDA
    tensors; ``axpy_dot_cuda.launches`` counts calls."""
    _check_vectors("axpy_dot_cuda", x, y, z)
    lib = _cuda.load()
    a = _scalar(alpha, x)
    yn = torch.empty_like(y)
    partial, dot = _reduce_out(lib, x.numel(), x.device)
    fn = getattr(lib, f"gt_axpy_dot_{_cuda.suffix(x.dtype)}")
    rc = fn(a.data_ptr(), x.data_ptr(), y.data_ptr(), z.data_ptr(),
            yn.data_ptr(), partial.data_ptr(), dot.data_ptr(), x.numel(),
            partial.numel(), x.device.index, _cuda.stream_of(x))
    _cuda.check(rc, "axpy_dot_cuda")
    axpy_dot_cuda.launches += 1
    return yn, dot


axpy_dot_cuda.launches = 0


def cg_fused_update(x, r, p, ap, alpha):
    """(x+αp, r−α·ap, ‖r−α·ap‖²_local) in one pass; the sum is float32.
    The plain version for CPU tensors, K7a for CUDA tensors."""
    if x.device.type == "cpu":
        return cg_fused_update_plain(x, r, p, ap, alpha)
    return cg_fused_update_cuda(x, r, p, ap, alpha)


def axpy_dot(alpha, x, y, z):
    """(y+αx, (y+αx)·z_local) in one pass; the dot is float32. The plain
    version for CPU tensors, K7b for CUDA tensors."""
    if x.device.type == "cpu":
        return axpy_dot_plain(alpha, x, y, z)
    return axpy_dot_cuda(alpha, x, y, z)
