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
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from gmres_tpu_torch.ops import _cuda

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
