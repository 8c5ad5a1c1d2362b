"""5-point stencil: plain PyTorch versions and kernel K1.

Counterpart of ``gmres_tpu/ops/stencil.py``:

* ``stencil_5pt_general`` / ``stencil_5pt_apply`` / ``stencil_5pt_halo`` —
  the plain versions (zero-filled shifts, explicit halo rows). They run on
  any device; the routed entry points below use them only for CPU tensors.
* ``stencil_5pt_pallas_halo`` / ``stencil_5pt_pallas`` /
  ``stencil_5pt_pallas_blocked`` — kernel K1 (``csrc/stencil5.cu``) behind
  the names and data arguments of the Pallas entry points. Two Pallas
  arguments have no counterpart: ``interpret`` (the tensor's device
  decides) and ``block_rows`` (one launch covers any grid).
* ``stencil_5pt_routed`` / ``stencil_5pt_routed_general`` — route by
  device: a CPU tensor takes the plain version, a CUDA tensor of float32 or
  float64 launches K1, and any other CUDA dtype raises. This replaces the
  TPU gate ``_pallas_routable`` (f32-only, VMEM-feasible tilings).
* ``stencil_5pt_dd_pallas_blocked`` / ``stencil_5pt_dd_general_pallas_blocked``
  — the float64-accurate stencil on (hi, lo) float32 pairs: kernel K6
  (``csrc/stencil5_dd.cu``) for a CUDA pair, the plain float64 route for a
  CPU pair; ``stencil_5pt_f64_via_dd``, ``stencil_5pt_f64_dd_chain`` and
  ``stencil_5pt_general_f64_via_dd`` split, apply and recombine.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from gmres_tpu_torch.ops import _cuda
from gmres_tpu_torch.ops.dd import dd_from_f64, dd_to_f64

POISSON_COEFS = (4.0, -1.0, -1.0, -1.0, -1.0)


def _shift(x: torch.Tensor, dr: int, dc: int) -> torch.Tensor:
    """x shifted by (dr, dc) ∈ {−1, 0, 1}² with zero fill."""
    if dc == 1:
        x = F.pad(x[:, :-1], (1, 0))
    elif dc == -1:
        x = F.pad(x[:, 1:], (0, 1))
    if dr == 1:
        x = F.pad(x[:-1, :], (0, 0, 1, 0))
    elif dr == -1:
        x = F.pad(x[1:, :], (0, 0, 0, 1))
    return x


def stencil_5pt_general(
    x: torch.Tensor,
    center: float,
    west: float,
    east: float,
    south: float,
    north: float,
) -> torch.Tensor:
    """y(i,j) = center·x(i,j) + west·x(i,j−1) + east·x(i,j+1)
    + south·x(i−1,j) + north·x(i+1,j), zero outside the grid."""
    return (
        center * x
        + west * _shift(x, 0, 1)
        + east * _shift(x, 0, -1)
        + south * _shift(x, 1, 0)
        + north * _shift(x, -1, 0)
    )


def stencil_5pt_apply(x: torch.Tensor) -> torch.Tensor:
    """Laplacian special case: y = 4x − (W+E+S+N)."""
    return stencil_5pt_general(x, *POISSON_COEFS)


def stencil_5pt_halo(
    x: torch.Tensor,
    top: torch.Tensor,
    bottom: torch.Tensor,
    coefs=POISSON_COEFS,
) -> torch.Tensor:
    """Stencil over a (rows, N) block with explicit halo rows: ``top`` is
    the row above the block, ``bottom`` the row below (zeros at the
    physical boundary)."""
    c0, cw, ce, cs, cn = coefs
    ext = torch.cat([top.reshape(1, -1), x, bottom.reshape(1, -1)], dim=0)
    mid = ext[1:-1, :]
    up = ext[:-2, :]
    down = ext[2:, :]
    left = F.pad(mid[:, :-1], (1, 0))
    right = F.pad(mid[:, 1:], (0, 1))
    return c0 * mid + cw * left + ce * right + cs * up + cn * down


# ---------------------------------------------------------------------------
# Kernel K1.
# ---------------------------------------------------------------------------


def _coef_list(coefs) -> list[float]:
    if coefs is None:
        return list(POISSON_COEFS)
    if isinstance(coefs, torch.Tensor):
        coefs = coefs.detach().cpu().tolist()
    vals = [float(c) for c in coefs]
    if len(vals) != 5:
        raise ValueError(f"expected 5 stencil coefficients, got {len(vals)}")
    return vals


def _halo_row(h, x: torch.Tensor, what: str):
    """Pointer of a (N,) or (1, N) halo row matching x, or None."""
    if h is None:
        return None
    if (h.device != x.device or h.dtype != x.dtype
            or h.numel() != x.shape[1] or not h.is_contiguous()):
        raise ValueError(
            f"{what}: halo row must be a contiguous ({x.shape[1]},) tensor "
            f"of {x.dtype} on {x.device}"
        )
    return h.data_ptr()


def stencil5_cuda(x: torch.Tensor, top=None, bottom=None,
                  coefs=None) -> torch.Tensor:
    """Launch K1 on a CUDA (rows, N) block; ``top``/``bottom`` are the halo
    rows, None for a zero row. ``stencil5_cuda.launches`` counts launches."""
    _cuda.check_grid(x, "stencil5_cuda")
    c = _coef_list(coefs)
    top_p = _halo_row(top, x, "stencil5_cuda")
    bot_p = _halo_row(bottom, x, "stencil5_cuda")
    y = torch.empty_like(x)
    lib = _cuda.load()
    fn = getattr(lib, f"gt_stencil5_{_cuda.suffix(x.dtype)}")
    rc = fn(x.data_ptr(), top_p, bot_p, y.data_ptr(), x.shape[0], x.shape[1],
            *c, x.device.index, _cuda.stream_of(x))
    _cuda.check(rc, "stencil5_cuda")
    stencil5_cuda.launches += 1
    return y


stencil5_cuda.launches = 0


def stencil_5pt_pallas_halo(
    x: torch.Tensor,
    top: torch.Tensor,
    bottom: torch.Tensor,
    coefs=None,
) -> torch.Tensor:
    """Stencil over a (rows, N) block with explicit (N,) or (1, N) halo
    rows: the plain version for a CPU tensor, K1 for a CUDA tensor."""
    if x.device.type == "cpu":
        c = _coef_list(coefs)
        return stencil_5pt_halo(x, top, bottom, c)
    return stencil5_cuda(x, top, bottom, coefs)


def stencil_5pt_pallas(x: torch.Tensor, coefs=None) -> torch.Tensor:
    """Stencil on a full (N, N) grid with zero (Dirichlet) halos."""
    if x.device.type == "cpu":
        return stencil_5pt_general(x, *_coef_list(coefs))
    return stencil5_cuda(x, None, None, coefs)


# The TPU's row-blocked variant exists for VMEM; K1 takes any grid in one
# launch, so the blocked entry point is the same function.
stencil_5pt_pallas_blocked = stencil_5pt_pallas


def stencil_5pt_routed(x: torch.Tensor) -> torch.Tensor:
    """Laplacian stencil routed by device (see module docstring)."""
    return stencil_5pt_pallas(x, POISSON_COEFS)


def stencil_5pt_routed_general(x: torch.Tensor, coefs) -> torch.Tensor:
    """General-coefficient form of ``stencil_5pt_routed``."""
    return stencil_5pt_pallas(x, coefs)


def stencil_blocked_feasible(n: int) -> bool:
    """True iff K1 (and K6) can take an (n, n) grid. The TPU version asks
    whether a VMEM row tiling exists; one launch here covers every grid
    within ``_cuda.check_grid``'s limits."""
    return 1 <= n <= 65535 * 8 and n * n < 2**31


# ---------------------------------------------------------------------------
# Kernel K6: the float64-accurate stencil on (hi, lo) float32 pairs.
# ---------------------------------------------------------------------------


def stencil_5pt_dd_plain(x_hi: torch.Tensor, x_lo: torch.Tensor,
                         coefs=POISSON_COEFS):
    """The plain PyTorch version of K6 (runs on any device): the pair
    widened to float64 (hi + lo), ``stencil_5pt_general`` in float64 with
    the float64 coefficients, split back by ``dd_from_f64``."""
    x = x_hi.to(torch.float64) + x_lo.to(torch.float64)
    return dd_from_f64(stencil_5pt_general(x, *_coef_list(coefs)))


def _check_pair(x_hi: torch.Tensor, x_lo: torch.Tensor, what: str) -> None:
    for t in (x_hi, x_lo):
        _cuda.check_grid(t, what)
        if t.dtype != torch.float32:
            raise TypeError(f"{what}: a pair is two float32 tensors, not {t.dtype}")
    if x_hi.shape != x_lo.shape or x_hi.device != x_lo.device:
        raise ValueError(f"{what}: hi and lo differ in shape or device")


def stencil5_dd_cuda(x_hi: torch.Tensor, x_lo: torch.Tensor, coefs=None):
    """Launch K6 on a CUDA (hi, lo) float32 pair; returns the result pair.
    ``stencil5_dd_cuda.launches`` counts launches."""
    _check_pair(x_hi, x_lo, "stencil5_dd_cuda")
    c = _coef_list(coefs)
    y_hi, y_lo = torch.empty_like(x_hi), torch.empty_like(x_lo)
    rc = _cuda.load().gt_stencil5_dd(
        x_hi.data_ptr(), x_lo.data_ptr(), y_hi.data_ptr(), y_lo.data_ptr(),
        x_hi.shape[0], x_hi.shape[1], *c, x_hi.device.index,
        _cuda.stream_of(x_hi))
    _cuda.check(rc, "stencil5_dd_cuda")
    stencil5_dd_cuda.launches += 1
    return y_hi, y_lo


stencil5_dd_cuda.launches = 0


def stencil_5pt_dd_general_pallas_blocked(x_hi: torch.Tensor,
                                          x_lo: torch.Tensor, coefs):
    """Stencil with five arbitrary float64 coefficients on a (hi, lo)
    float32 pair, pair in and pair out: the plain version for a CPU pair,
    K6 for a CUDA pair. More accurate than the JAX kernel's ~2⁻⁴⁸ (see
    ``csrc/stencil5_dd.cu``). The Pallas arguments ``interpret`` and
    ``block_rows`` have no counterpart: the pair's device decides, and one
    launch covers any grid. The coefficients need no pre-split
    (``coef_split12`` exists only for Mosaic)."""
    if x_hi.device.type == "cpu":
        return stencil_5pt_dd_plain(x_hi, x_lo, coefs)
    return stencil5_dd_cuda(x_hi, x_lo, coefs)


def stencil_5pt_dd_pallas_blocked(x_hi: torch.Tensor, x_lo: torch.Tensor):
    """Poisson stencil on a (hi, lo) float32 pair, routed like
    ``stencil_5pt_dd_general_pallas_blocked`` (the coefficients
    (4, −1, −1, −1, −1) are exact in float64, so one kernel serves both)."""
    return stencil_5pt_dd_general_pallas_blocked(x_hi, x_lo, POISSON_COEFS)


def stencil_5pt_f64_via_dd(x: torch.Tensor) -> torch.Tensor:
    """One float64 Poisson stencil application through the pair route:
    split, K6 (or its plain version), recombine."""
    return dd_to_f64(stencil_5pt_dd_pallas_blocked(*dd_from_f64(x)))


def stencil_5pt_f64_dd_chain(x: torch.Tensor, k: int) -> torch.Tensor:
    """k chained float64 Poisson applications in pair space (one split, one
    recombine), as a pair-resident solver loop would run them. The pair
    keeps float32's exponent range: the unnormalised Laplacian grows up to
    8× a step, so chains much past 20 overflow hi."""
    hi, lo = dd_from_f64(x)
    for _ in range(k):
        hi, lo = stencil_5pt_dd_pallas_blocked(hi, lo)
    return dd_to_f64((hi, lo))


def stencil_5pt_general_f64_via_dd(x: torch.Tensor, coefs) -> torch.Tensor:
    """One general-coefficient float64 stencil application through the pair
    route (split, kernel, recombine)."""
    return dd_to_f64(stencil_5pt_dd_general_pallas_blocked(*dd_from_f64(x), coefs))
