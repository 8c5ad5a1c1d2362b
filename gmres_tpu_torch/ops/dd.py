"""The (hi, lo) float32 pair: constructors only.

Counterpart of the last two functions of ``gmres_tpu/ops/dd.py``. The JAX
module is double-double arithmetic on float32 pairs (error-free sums and
products, 12-bit splits, value fences against XLA's rewrites) because
Mosaic has no float64. Hopper has native float64, so the port carries the
capability, not the workaround: kernel K6 (``csrc/stencil5_dd.cu``, behind
``ops/stencil.py``'s dd entry points) widens each pair to float64, works in
float64 and splits the result back. What stays is the pair as a storage
format — the signatures of the dd stencils take and return it — and its two
constructors here.
"""

from __future__ import annotations

import torch


def dd_from_f64(x: torch.Tensor):
    """Split a float64 tensor into the (hi, lo) float32 pair: hi is x rounded
    to float32, lo the float32 rounding of the exact remainder x − hi.
    Representation error ≤ 2⁻⁴⁹ relative."""
    hi = x.to(torch.float32)
    lo = (x - hi.to(x.dtype)).to(torch.float32)
    return hi, lo


def dd_to_f64(a) -> torch.Tensor:
    """Recombine a (hi, lo) pair to float64 (hi + lo in float64)."""
    return a[0].to(torch.float64) + a[1].to(torch.float64)
