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
* ``residual_restrict`` / ``correct_residual`` — K1's two fused forms for
  one V-cycle level (``precond/multigrid.py``), routed the same way:
  ``restrict_sum(r − A e)``, and ``e' = e + prolong_repeat(ec)`` with
  ``r − A e'``, each one launch on a CUDA tensor, bitwise equal to the
  composition (their plain versions) that a CPU tensor takes. XLA fused
  these jnp operations around the TPU kernel; eager PyTorch would run each
  as its own pass over the level.
* ``stencil_5pt_dd_pallas_blocked`` / ``stencil_5pt_dd_general_pallas_blocked``
  — the float64-accurate stencil on (hi, lo) float32 pairs: kernel K6
  (``csrc/stencil5_dd.cu``) for a CUDA pair, the plain float64 route for a
  CPU pair; ``stencil_5pt_f64_via_dd``, ``stencil_5pt_f64_dd_chain`` and
  ``stencil_5pt_general_f64_via_dd`` split, apply and recombine.
* ``stencil_7pt_general`` / ``stencil_7pt_apply`` — the 3-D 7-point
  stencil, plain PyTorch on any device (plain jnp in JAX too);
  ``stencil_7pt_halo`` its form on a block of planes with halo planes.

The DTensor route. gmres_tpu's GSPMD lowers the jnp shifts of a stencil
on a sharded grid to halo permutes; here ``stencil_5pt_pallas`` (and so
``stencil_5pt_routed``/``_routed_general``), ``stencil_5pt_general`` and
``stencil_7pt_general`` hand a DTensor to ``parallel/halo.py:
sharded_stencil``, which dispatches on its placement: ``[Shard(0)]`` on a
1-D mesh, evenly, is one halo exchange and one halo form on each rank's
block (K1's halo form for a real 5-point stencil); ``[Replicate()]`` is the
plain computation on the local tensor; any other placement raises
NotImplementedError. While ``parallel/halo.py:blockwise_jvp`` runs on
this thread, a plain tensor is taken as this rank's block of a row-sharded
grid and takes the same forms (how Newton–Krylov applies J·v to each
rank's block); that mode and its state belong to ``parallel/halo.py``,
which ``on_sharded_grid`` asks. No route gathers the grid. The
one-argument operators (``stencil_5pt_apply``, ``stencil_7pt_apply``,
``stencil_5pt_pallas``, ``stencil_5pt_routed``) are marked as taking a
block of rows of a sharded grid whole (``ops/blas.py:row_blocks``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from gmres_tpu_torch.ops import _cuda
from gmres_tpu_torch.ops.blas import dtensor_of, row_blocks
from gmres_tpu_torch.ops.dd import dd_from_f64, dd_to_f64

POISSON_COEFS = (4.0, -1.0, -1.0, -1.0, -1.0)

def on_sharded_grid(x) -> bool:
    """True where x goes by the DTensor route: a DTensor (also inside a
    ``torch.func`` transform), or a rank's block while
    ``parallel/halo.py:blockwise_jvp`` runs on this thread."""
    if dtensor_of(x) is not None:
        return True
    from gmres_tpu_torch.parallel.halo import blockwise_active

    return blockwise_active()


def _halo_route(x, kind: str, coefs):
    from gmres_tpu_torch.parallel.halo import sharded_stencil

    return sharded_stencil(x, kind, coefs)


def _shift(x: torch.Tensor, dr: int, dc: int) -> torch.Tensor:
    """x shifted by (dr, dc) ∈ {−1, 0, 1}² along its last two dimensions,
    with zero fill (a (lanes, rows, cols) block shifts each lane)."""
    if dc == 1:
        x = F.pad(x[..., :-1], (1, 0))
    elif dc == -1:
        x = F.pad(x[..., 1:], (0, 1))
    if dr == 1:
        x = F.pad(x[..., :-1, :], (0, 0, 1, 0))
    elif dr == -1:
        x = F.pad(x[..., 1:, :], (0, 0, 0, 1))
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
    + south·x(i−1,j) + north·x(i+1,j), zero outside the grid, on the last
    two dimensions (a (lanes, rows, cols) block is one stencil a lane, with
    (lanes, 1, 1) coefficients where they differ by lane). A DTensor goes by
    the DTensor route (module docstring)."""
    if on_sharded_grid(x):
        return _halo_route(x, "5pt", (center, west, east, south, north))
    return (
        center * x
        + west * _shift(x, 0, 1)
        + east * _shift(x, 0, -1)
        + south * _shift(x, 1, 0)
        + north * _shift(x, -1, 0)
    )


@row_blocks
def stencil_5pt_apply(x: torch.Tensor) -> torch.Tensor:
    """Laplacian special case: y = 4x − (W+E+S+N)."""
    return stencil_5pt_general(x, *POISSON_COEFS)


def _shift3(x: torch.Tensor, d0: int, axis: int) -> torch.Tensor:
    """Single-axis shift of a 3-D grid (or of each lane of a block of them,
    ``axis`` counted from the end) by ``d0`` with zero fill."""
    y = torch.zeros_like(x)
    n = x.shape[axis]
    if d0 > 0:
        y.narrow(axis, d0, n - d0).copy_(x.narrow(axis, 0, n - d0))
    else:
        y.narrow(axis, 0, n + d0).copy_(x.narrow(axis, -d0, n + d0))
    return y


def stencil_7pt_general(x: torch.Tensor, center: float,
                        off: float = -1.0) -> torch.Tensor:
    """3-D 7-point stencil y = center·x + off·(sum of the 6 face
    neighbours), zero outside the grid; the neighbours are summed in the
    JAX order, so the bits are JAX's. Plain PyTorch, as the JAX version is
    plain jnp. A DTensor goes by the DTensor route (module docstring)."""
    if on_sharded_grid(x):
        return _halo_route(x, "7pt", (center, off))
    s = (
        _shift3(x, 1, 0) + _shift3(x, -1, 0)
        + _shift3(x, 1, 1) + _shift3(x, -1, 1)
        + _shift3(x, 1, 2) + _shift3(x, -1, 2)
    )
    return center * x + off * s


@row_blocks
def stencil_7pt_apply(x: torch.Tensor) -> torch.Tensor:
    """3-D Laplacian special case: y = 6x − Σ face neighbours."""
    return stencil_7pt_general(x, 6.0)


def stencil_7pt_halo(x: torch.Tensor, top, bottom, center: float,
                     off: float = -1.0) -> torch.Tensor:
    """``stencil_7pt_general`` on a (planes, N, N) block with explicit halo
    planes along axis 0: ``top`` the plane before the block, ``bottom`` the
    one after (None is a zero plane, the physical boundary). The neighbours
    are summed in ``stencil_7pt_general``'s order, so a block with its true
    halo planes gives the bits of the whole grid's rows. A (lanes, planes,
    N, N) block takes (lanes, 1, N, N) halo planes, lane ℓ's its own, and
    gives each lane the bits of its own call."""
    shape = tuple(x.shape[:-3]) + (1,) + tuple(x.shape[-2:])

    def plane(h):
        if h is None:
            return torch.zeros(shape, dtype=x.dtype, device=x.device)
        return h.reshape(shape)

    ext = torch.cat([plane(top), x, plane(bottom)], dim=-3)
    s = (
        ext[..., :-2, :, :] + ext[..., 2:, :, :]
        + _shift3(x, 1, -2) + _shift3(x, -1, -2)
        + _shift3(x, 1, -1) + _shift3(x, -1, -1)
    )
    return center * x + off * s


def stencil_5pt_halo(
    x: torch.Tensor,
    top: torch.Tensor | None,
    bottom: torch.Tensor | None,
    coefs=POISSON_COEFS,
) -> torch.Tensor:
    """Stencil over a (rows, N) block with explicit halo rows: ``top`` is
    the row above the block, ``bottom`` the row below (zeros at the
    physical boundary; None is a zero row, as K1 reads a null pointer). A
    (lanes, rows, N) block takes (lanes, 1, N) halo rows, lane ℓ's its own
    (the halo route's block form), and gives each lane the bits of its own
    call."""
    c0, cw, ce, cs, cn = coefs
    shape = tuple(x.shape[:-2]) + (1, x.shape[-1])

    def row(h):
        if h is None:
            return torch.zeros(shape, dtype=x.dtype, device=x.device)
        return h.reshape(shape)

    ext = torch.cat([row(top), x, row(bottom)], dim=-2)
    mid = ext[..., 1:-1, :]
    up = ext[..., :-2, :]
    down = ext[..., 2:, :]
    left = F.pad(mid[..., :-1], (1, 0))
    right = F.pad(mid[..., 1:], (0, 1))
    return c0 * mid + cw * left + ce * right + cs * up + cn * down


# ---------------------------------------------------------------------------
# Kernel K1.
# ---------------------------------------------------------------------------


def _coef_terms(coefs) -> list:
    """The five coefficients as given: Python floats, or 0-d tensors where
    a coefficient is a tensor (a (5,) tensor gives five), never detached, so
    that a coefficient that requires grad stays in the graph."""
    if coefs is None:
        return list(POISSON_COEFS)
    if isinstance(coefs, torch.Tensor):
        coefs = coefs.reshape(-1).unbind()
    vals = [c if isinstance(c, torch.Tensor) else float(c) for c in coefs]
    if len(vals) != 5:
        raise ValueError(f"expected 5 stencil coefficients, got {len(vals)}")
    return vals


def _coef_list(coefs, what: str | None = None, kernel: str | None = None) -> list[float]:
    """The five coefficients' values as Python floats, for a launch (a
    tensor coefficient's value is read, a host read on the card). Given the
    launching wrapper and its kernel, a coefficient tensor that autograd or
    torch.func tracks raises first (``_cuda.refuse_transforms``): the launch
    would drop its gradient."""
    if what is not None:
        terms = coefs if isinstance(coefs, (list, tuple)) else (coefs,)
        _cuda.refuse_dtensor(what, kernel, *terms)
        _cuda.refuse_transforms(what, kernel, *terms)
    if isinstance(coefs, torch.Tensor):
        coefs = coefs.detach().cpu().tolist()  # one read for all five
    return [float(c) for c in _coef_terms(coefs)]


def _halo_row(h, x: torch.Tensor, what: str, kernel: str):
    """Pointer of a (N,) or (1, N) halo row matching the grid x, or of a
    (lanes, 1, N) or (lanes, N) block of them, lane ℓ's row its own, matching
    the (lanes, rows, N) block x; or None."""
    if h is None:
        return None
    _cuda.refuse_dtensor(what, kernel, h)
    _cuda.refuse_transforms(what, kernel, h)
    lanes = x.shape[0] if x.dim() == 3 else 1
    if (h.device != x.device or h.dtype != x.dtype or not h.is_contiguous()
            or h.numel() != lanes * x.shape[-1]
            or (x.dim() == 3 and (h.dim() < 2 or h.shape[0] != lanes))):
        want = f"({lanes}, 1, {x.shape[-1]})" if x.dim() == 3 else f"({x.shape[-1]},)"
        raise ValueError(
            f"{what}: halo row must be a contiguous {want} tensor "
            f"of {x.dtype} on {x.device}"
        )
    return h.data_ptr()


def _per_lane(coefs) -> bool:
    """Whether ``coefs`` is a (lanes, 5) tensor of per-lane coefficients."""
    return isinstance(coefs, torch.Tensor) and coefs.dim() == 2


def stencil5_cuda(x: torch.Tensor, top=None, bottom=None,
                  coefs=None) -> torch.Tensor:
    """Launch K1 on a CUDA (rows, N) block; ``top``/``bottom`` are the halo
    rows, None for a zero row. On a (lanes, rows, N) block (what jax.vmap
    makes of the Pallas kernel: a leading grid axis), one launch for all
    lanes, each lane the bits of its own launch; the halo rows are then
    (lanes, 1, N) blocks, lane ℓ's row its own (the halo route's block
    form), and ``coefs`` may be a (lanes, 5) tensor, one set a lane (copied
    to the card in the block's dtype, no host read).
    ``stencil5_cuda.launches`` counts launches, ``.batched_launches`` those
    on a block. No autograd rule: a
    tracked operand, halo row or coefficient raises
    (``_cuda.refuse_transforms``); the differentiable full-grid route is
    ``stencil5_grid``."""
    per_lane = None
    if _per_lane(coefs):
        _cuda.refuse_dtensor("stencil5_cuda", "K1", coefs)
        _cuda.refuse_transforms("stencil5_cuda", "K1", coefs)
        c = [0.0] * 5
    else:
        c = _coef_list(coefs, "stencil5_cuda", "K1")
    _cuda.check_grid("stencil5_cuda", "K1", x, lanes=True)
    lanes = x.shape[0] if x.dim() == 3 else 1
    if _per_lane(coefs):
        if x.dim() != 3 or tuple(coefs.shape) != (lanes, 5):
            raise ValueError(f"stencil5_cuda: per-lane coefficients must be ({lanes}, 5) "
                             f"on a block, got {tuple(coefs.shape)}")
        per_lane = coefs.to(device=x.device, dtype=x.dtype).contiguous()
    top_p = _halo_row(top, x, "stencil5_cuda", "K1")
    bot_p = _halo_row(bottom, x, "stencil5_cuda", "K1")
    y = torch.empty_like(x)
    rc = _cuda.entry("gt_stencil5", x.dtype)(
        x.data_ptr(), top_p, bot_p, y.data_ptr(), lanes, x.shape[-2], x.shape[-1], *c,
        None if per_lane is None else per_lane.data_ptr(), x.device.index,
        _cuda.stream_of(x))
    _cuda.check(rc, "stencil5_cuda")
    stencil5_cuda.launches += 1
    stencil5_cuda.batched_launches += int(x.dim() == 3)
    return y


stencil5_cuda.launches = 0
stencil5_cuda.batched_launches = 0


# ---------------------------------------------------------------------------
# K1's fused forms for one V-cycle level.
# ---------------------------------------------------------------------------


def restrict_sum(x: torch.Tensor) -> torch.Tensor:
    """(2m, 2m) → (m, m) by 2×2 block sum (residual transfer for
    h²-scaled operators), summed rows first as in the JAX version; on the
    last two dimensions (a (lanes, 2m, 2m) block restricts each lane)."""
    y = x[..., 0::2, :] + x[..., 1::2, :]
    return y[..., 0::2] + y[..., 1::2]


def prolong_repeat(x: torch.Tensor) -> torch.Tensor:
    """(m, m) → (2m, 2m) by replication, on the last two dimensions."""
    return x.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)


def _check_levels(what: str, r: torch.Tensor, e: torch.Tensor, ec=None) -> None:
    """r and e one fine (2m, 2mc) grid of one dtype and device; ec, where
    given, the coarse (m, mc) grid. Or (lanes, …) blocks of such grids,
    the same lanes in each."""
    lead = tuple(r.shape[:1]) if r.dim() == 3 else ()
    if r.dim() not in (2, 3) or r.shape[-2] % 2 or r.shape[-1] % 2:
        raise ValueError(f"{what}: the fine grid must have even sides, got "
                         f"{tuple(r.shape)}")
    for t, shape in ((e, r.shape), (ec, lead + (r.shape[-2] // 2, r.shape[-1] // 2))):
        if t is not None and (tuple(t.shape) != tuple(shape) or t.dtype != r.dtype
                              or t.device != r.device):
            raise ValueError(f"{what}: expected a {tuple(shape)} {r.dtype} grid on "
                             f"{r.device}, got {tuple(t.shape)} {t.dtype} on {t.device}")


def residual_restrict_plain(r: torch.Tensor, e: torch.Tensor,
                            coefs=POISSON_COEFS) -> torch.Tensor:
    """The plain version of K1's residual-restrict form, the composition
    restrict_sum(r − A e) (runs on any device; a tensor coefficient stays in
    the graph)."""
    return restrict_sum(r - stencil_5pt_general(e, *_coef_terms(coefs)))


def correct_residual_plain(r: torch.Tensor, e: torch.Tensor, ec: torch.Tensor,
                           coefs=POISSON_COEFS):
    """The plain version of K1's correct-residual form, the composition
    e' = e + prolong_repeat(ec), r − A e' (runs on any device; a tensor
    coefficient stays in the graph)."""
    e2 = e + prolong_repeat(ec)
    return e2, r - stencil_5pt_general(e2, *_coef_terms(coefs))


def residual_restrict_cuda(r: torch.Tensor, e: torch.Tensor,
                           coefs=None) -> torch.Tensor:
    """Launch K1's residual-restrict form on CUDA (2m, 2mc) grids r and e,
    or once on (lanes, 2m, 2mc) blocks; returns the (m, mc) grid (the
    (lanes, m, mc) block). ``residual_restrict_cuda.launches`` counts
    launches, ``.batched_launches`` those on blocks."""
    c = _coef_list(coefs, "residual_restrict_cuda", "K1rr")
    _cuda.check_grid("residual_restrict_cuda", "K1rr", r, e, lanes=True)
    _check_levels("residual_restrict_cuda", r, e)
    lead, (mr, mc) = r.shape[:-2], (r.shape[-2] // 2, r.shape[-1] // 2)
    out = torch.empty(lead + (mr, mc), dtype=r.dtype, device=r.device)
    rc = _cuda.entry("gt_residual_restrict", r.dtype)(
        r.data_ptr(), e.data_ptr(), out.data_ptr(), lead.numel(), mr, mc, *c,
        r.device.index, _cuda.stream_of(r))
    _cuda.check(rc, "residual_restrict_cuda")
    residual_restrict_cuda.launches += 1
    residual_restrict_cuda.batched_launches += int(r.dim() == 3)
    return out


residual_restrict_cuda.launches = 0
residual_restrict_cuda.batched_launches = 0


def correct_residual_cuda(r: torch.Tensor, e: torch.Tensor, ec: torch.Tensor,
                          coefs=None):
    """Launch K1's correct-residual form on CUDA grids (fine r and e, coarse
    ec), or once on (lanes, …) blocks of them; returns (e', r − A e').
    ``correct_residual_cuda.launches`` counts launches, ``.batched_launches``
    those on blocks."""
    c = _coef_list(coefs, "correct_residual_cuda", "K1cr")
    _cuda.check_grid("correct_residual_cuda", "K1cr", r, e, ec, lanes=True)
    _check_levels("correct_residual_cuda", r, e, ec)
    e_out, r_out = torch.empty_like(e), torch.empty_like(r)
    rc = _cuda.entry("gt_correct_residual", r.dtype)(
        r.data_ptr(), e.data_ptr(), ec.data_ptr(), e_out.data_ptr(),
        r_out.data_ptr(), r.shape[:-2].numel(), ec.shape[-2], ec.shape[-1], *c,
        r.device.index, _cuda.stream_of(r))
    _cuda.check(rc, "correct_residual_cuda")
    correct_residual_cuda.launches += 1
    correct_residual_cuda.batched_launches += int(r.dim() == 3)
    return e_out, r_out


correct_residual_cuda.launches = 0
correct_residual_cuda.batched_launches = 0


def residual_restrict(r: torch.Tensor, e: torch.Tensor,
                      coefs=POISSON_COEFS) -> torch.Tensor:
    """restrict_sum(r − A e), routed by device: the plain composition for a
    CPU tensor, K1's residual-restrict form for a CUDA tensor; r and e
    grids or (lanes, …) blocks. Under ``torch.func.vmap``, one call on the
    lanes' blocks (``ResidualRestrict``'s vmap rule; one launch on the
    card); ``residual_restrict.block_calls`` counts calls on blocks."""
    if _cuda.vmapped(r, e):
        return _cuda.through_lanes(_rr_lanes, ResidualRestrict, r, e, *_coef_terms(coefs))
    residual_restrict.block_calls += int(r.dim() >= 3)
    if r.device.type == "cpu":
        _check_levels("residual_restrict", r, e)
        return residual_restrict_plain(r, e, coefs)
    if r.dim() > 3:
        out = residual_restrict_cuda(_flat_lanes(r), _flat_lanes(e), coefs)
        return out.reshape(r.shape[:-2] + out.shape[-2:])
    return residual_restrict_cuda(r, e, coefs)


def correct_residual(r: torch.Tensor, e: torch.Tensor, ec: torch.Tensor,
                     coefs=POISSON_COEFS):
    """(e + prolong_repeat(ec), r − A(e + prolong_repeat(ec))), routed by
    device: the plain composition for a CPU tensor, K1's correct-residual
    form for a CUDA tensor; grids or (lanes, …) blocks. Under
    ``torch.func.vmap``, one call on the lanes' blocks (``CorrectResidual``'s
    vmap rule); ``correct_residual.block_calls`` counts calls on blocks."""
    if _cuda.vmapped(r, e, ec):
        return _cuda.through_lanes(_cr_lanes, CorrectResidual, r, e, ec,
                                   *_coef_terms(coefs))
    correct_residual.block_calls += int(r.dim() >= 3)
    if r.device.type == "cpu":
        _check_levels("correct_residual", r, e, ec)
        return correct_residual_plain(r, e, ec, coefs)
    if r.dim() > 3:
        e2, r2 = correct_residual_cuda(_flat_lanes(r), _flat_lanes(e), _flat_lanes(ec),
                                       coefs)
        return e2.reshape(e.shape), r2.reshape(r.shape)
    return correct_residual_cuda(r, e, ec, coefs)


residual_restrict.block_calls = 0
correct_residual.block_calls = 0


# ---------------------------------------------------------------------------
# K1's vmap rules: a block application (``torch.func.vmap`` of an operator
# or a V-cycle, ``ops/blas.py:row_apply``) reaches K1's launches on a
# (lanes, rows, cols) block, what jax.vmap makes of the Pallas kernel (a
# leading grid axis), through the rules below.
# ---------------------------------------------------------------------------


def _lanes_first(t: torch.Tensor, dim, lanes: int) -> torch.Tensor:
    """A vmap rule's operand as a contiguous (lanes, …) block: its batch
    dimension moved first, or the one tensor repeated where it is not
    batched."""
    if dim is None:
        return t.expand((lanes,) + tuple(t.shape)).contiguous()
    return t.movedim(dim, 0).contiguous()


def _lane_coefs(coefs, dims, lanes: int, device):
    """A vmap rule's five coefficients: as given where none is batched (one
    set for every lane), else a (lanes, 5) float64 tensor on ``device``, one
    set a lane (a float or an unbatched tensor repeated down its column)."""
    if all(d is None for d in dims):
        return list(coefs)
    cols = [c.movedim(d, 0).reshape(lanes) if d is not None
            else torch.as_tensor(c, dtype=torch.float64).reshape(()).expand(lanes)
            for c, d in zip(coefs, dims)]
    return torch.stack([c.to(device=device, dtype=torch.float64) for c in cols], dim=1)


def _shared_coefs(what: str, dims) -> None:
    """The V-cycle forms and K2 take one coefficient set for all lanes."""
    if any(d is not None for d in dims):
        raise NotImplementedError(
            f"{what}: coefficients that differ by lane reach K1's full-grid "
            "stencil only; the V-cycle forms and K2 take one set for every lane "
            "(ROADMAP: batched forms)")


def _rr_lanes(dims, n, r, e, *coefs):
    """residual_restrict's vmap rule: one call on the lanes' blocks."""
    _shared_coefs("residual_restrict", dims[2:])
    return residual_restrict(_lanes_first(r, dims[0], n), _lanes_first(e, dims[1], n),
                             coefs)


def _cr_lanes(dims, n, r, e, ec, *coefs):
    """correct_residual's vmap rule: one call on the lanes' blocks."""
    _shared_coefs("correct_residual", dims[3:])
    return correct_residual(_lanes_first(r, dims[0], n), _lanes_first(e, dims[1], n),
                            _lanes_first(ec, dims[2], n), coefs)


class ResidualRestrict(torch.autograd.Function):
    """``residual_restrict`` under ``torch.func.vmap``: its vmap rule makes
    one ``residual_restrict`` call on the lanes' blocks (one K1rr launch on
    the card); ``_cuda.through_lanes`` takes the same rule without the
    Function where vmap is the only transform. No autograd rule, as
    ``residual_restrict_cuda`` has none."""

    @staticmethod
    def forward(r, e, *coefs):
        return residual_restrict(r, e, coefs)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, *args):
        return _rr_lanes(in_dims, info.batch_size, *args), 0


class CorrectResidual(torch.autograd.Function):
    """``correct_residual`` under ``torch.func.vmap``: one
    ``correct_residual`` call on the lanes' blocks (one K1cr launch on the
    card), as ``ResidualRestrict``."""

    @staticmethod
    def forward(r, e, ec, *coefs):
        return correct_residual(r, e, ec, coefs)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, *args):
        return _cr_lanes(in_dims, info.batch_size, *args), (0, 0)


def stencil_5pt_pallas_halo(
    x: torch.Tensor,
    top: torch.Tensor | None,
    bottom: torch.Tensor | None,
    coefs=None,
) -> torch.Tensor:
    """Stencil over a (rows, N) block with explicit (N,) or (1, N) halo
    rows, None for a zero row: the plain version for a CPU tensor, K1 for a
    CUDA tensor. A (lanes, rows, N) block of s rows' blocks (the halo
    route's block form) takes (lanes, 1, N) halo rows, lane ℓ's its own: one
    launch, each lane the bits of its own call.
    ``stencil_5pt_pallas_halo.launches`` counts the K1 launches taken
    through this halo form (each one also counted by
    ``stencil5_cuda.launches``), ``.batched_launches`` those on a block. The
    block is a rank's own: a DTensor raises TypeError on either device
    (``_cuda.refuse_dtensor``)."""
    _cuda.refuse_dtensor("stencil_5pt_pallas_halo", "K1", x, top, bottom)
    if x.device.type == "cpu":
        return stencil_5pt_halo(x, top, bottom, _coef_terms(coefs))
    y = stencil5_cuda(x, top, bottom, coefs)
    stencil_5pt_pallas_halo.launches += 1
    stencil_5pt_pallas_halo.batched_launches += int(x.dim() == 3)
    return y


stencil_5pt_pallas_halo.launches = 0
stencil_5pt_pallas_halo.batched_launches = 0


# The coefficients' neighbour shifts, in (center, west, east, south, north)
# order: y = Σₖ cₖ·shiftₖ(x), so ∂y/∂cₖ = shiftₖ(x).
_COEF_SHIFTS = ((0, 0), (0, 1), (0, -1), (1, 0), (-1, 0))


def _k1_grid(x: torch.Tensor, vals) -> torch.Tensor:
    """One full-grid application with float coefficients on a grid or a
    (lanes, rows, cols) block: the plain version for a CPU tensor, one K1
    launch for a CUDA tensor."""
    if x.device.type == "cpu":
        return stencil_5pt_general(x, *vals)
    return stencil5_cuda(x, None, None, vals)


def _k1_lanes(dims, n, x, *coefs):
    """K1's vmap rule: one ``stencil_5pt_pallas`` call on the lanes' block,
    with a (lanes, 5) coefficient array where a coefficient is batched."""
    xb = _lanes_first(x, dims[0], n)
    return stencil_5pt_pallas(xb, _lane_coefs(coefs, dims[1:], n, xb.device))


class Stencil5Grid(torch.autograd.Function):
    """K1 on a full grid with zero (Dirichlet) halos, differentiable.

    ``Stencil5Grid.apply(x, c, w, e, s, n)``: each coefficient a float or a
    0-d tensor. The forward is one launch (``_k1_grid``). The rules:

    * backward: Aᵀ of a 5-point stencil with zero halos is the same stencil
      with west↔east and south↔north swapped, so x's cotangent is one more
      application with (c, e, w, n, s);
    * jvp: the stencil is linear in x, so x's tangent maps through one
      application with the same coefficients;
    * a coefficient that is a tensor: ∂y/∂cₖ = shiftₖ(x), so its gradient
      is Σ ȳ·shiftₖ(x) and its tangent adds ċₖ·shiftₖ(x), plain torch
      reductions and products on any device (gmres_tpu gets the same terms
      from autodiff of its jnp stencil).

    The backward and the jvp apply this Function again rather than the
    wrapper, so they launch one K1 each and stay differentiable; inside a
    ``torch.func`` transform the forward receives unwrapped tensors, which
    a ctypes launch needs. On a CPU tensor the same rules run on the plain
    version (the tests' oracle for the card). ``rule_applications`` counts
    the backward's and the jvp's applications by rule.

    * vmap: the lanes of ``torch.func.vmap`` in one ``stencil_5pt_pallas``
      call on their (lanes, rows, cols) block (one K1 launch on a CUDA
      block, the plain version on a CPU block), with per-lane coefficients
      where a coefficient is batched (an operator family swept over
      lanes): ``_k1_lanes``, which ``stencil_5pt_pallas`` calls through
      ``_cuda.through_lanes`` without the Function where vmap is the only
      transform and nothing tracks the operands. Where autograd, forward-mode
      AD or another transform tracks them, the rule's call takes this
      Function on the block (``Stencil5Lanes`` with per-lane
      coefficients), whose rules then act on the whole block. A
      coefficient that a vmap level batches under another transform (a
      family's J·v inside vmap) stays a tensor in the rules (``_value``),
      and their applications reach the vmap rule with it."""

    @staticmethod
    def forward(x, *coefs):
        return _k1_grid(x, [float(c) for c in coefs])

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, *coefs = inputs
        ctx.vals = [_value(c) for c in coefs]
        ctx.coef_meta = [(c.shape, c.dtype) if isinstance(c, torch.Tensor) else None
                         for c in coefs]
        if any(m is not None for m in ctx.coef_meta):
            ctx.save_for_backward(x)
            ctx.save_for_forward(x)

    @staticmethod
    def backward(ctx, gy):
        c, w, e, s, n = ctx.vals
        gx = None
        if ctx.needs_input_grad[0]:
            Stencil5Grid.rule_applications["transpose"] += 1
            gx = Stencil5Grid.apply(gy, c, e, w, n, s)
        gcoefs = []
        for k, needs in enumerate(ctx.needs_input_grad[1:]):
            if not needs:
                gcoefs.append(None)
                continue
            (x,) = ctx.saved_tensors
            shape, dtype = ctx.coef_meta[k]
            g = torch.sum(gy * _shift(x, *_COEF_SHIFTS[k]))
            gcoefs.append(g.reshape(shape).to(dtype))
        return (gx, *gcoefs)

    @staticmethod
    def vmap(info, in_dims, *args):
        return _k1_lanes(in_dims, info.batch_size, *args), 0

    @staticmethod
    def jvp(ctx, gx, *gcoefs):
        out = None
        if gx is not None:
            Stencil5Grid.rule_applications["tangent"] += 1
            out = Stencil5Grid.apply(gx, *ctx.vals)
        for k, gc in enumerate(gcoefs):
            if gc is None:
                continue
            (x,) = ctx.saved_tensors
            term = gc * _shift(x, *_COEF_SHIFTS[k])
            out = term if out is None else out + term
        return out


# Applications of each rule (one launch each on the card, counted by the
# wrapper too): how many of stencil5_cuda's launches were transposes and
# tangents (``Stencil5Lanes`` counts its own here too).
Stencil5Grid.rule_applications = {"transpose": 0, "tangent": 0}


def _value(c):
    """A coefficient as a rule keeps it: its value as a float, or, where a
    ``torch.func.vmap`` level batches it (an operator family swept over
    lanes, read inside another transform), the detached tensor, which the
    rule's applications pass on to the vmap rule as per-lane values."""
    if isinstance(c, torch.Tensor) and _cuda.has_lanes(c):
        return c.detach()
    return float(c)


# The coefficients' order in K1's transpose: (c, w, e, s, n) → (c, e, w, n, s).
_MIRROR = (0, 2, 1, 4, 3)


class Stencil5Lanes(torch.autograd.Function):
    """K1 on a (lanes, rows, cols) block with a (lanes, 5) tensor of
    coefficients, one set a lane, differentiable: the per-lane route's
    counterpart of ``Stencil5Grid``.

    ``Stencil5Lanes.apply(xb, coefs)``. The forward is one launch on the
    block (the plain version on a CPU block). The rules:

    * backward in x: one launch on the cotangent block with each lane's
      coefficients mirrored, (c, e, w, n, s) (``_MIRROR``);
    * backward in the coefficients: Σ ȳ·shiftₖ(x) over each lane's grid, a
      (lanes, 5) cotangent;
    * jvp: one launch on the tangent block with the same coefficients, plus
      ċₖ·shiftₖ(x) for each lane where the coefficients carry a tangent.

    ``_k1_per_lane`` takes it on the card where autograd, forward-mode AD or
    a torch.func transform tracks the block or the coefficients (a vmap
    rule's call under another transform); the rules' applications go
    through it again, so they launch one K1 each and stay differentiable.
    Applied to a CPU block, the same rules run on the plain version (the
    tests' oracle for the card); ``_k1_per_lane`` itself keeps a CPU block
    on plain torch, whose autograd gives a batched lane the transposes'
    bits of its sequential solve. ``Stencil5Grid.rule_applications``
    counts the applications by rule."""

    @staticmethod
    def forward(xb, coefs):
        return _per_lane_apply(xb, coefs)

    @staticmethod
    def setup_context(ctx, inputs, output):
        xb, coefs = inputs
        ctx.coefs = coefs.detach()
        ctx.save_for_backward(xb)
        ctx.save_for_forward(xb)

    @staticmethod
    def backward(ctx, gy):
        (xb,) = ctx.saved_tensors
        gx = gc = None
        if ctx.needs_input_grad[0]:
            Stencil5Grid.rule_applications["transpose"] += 1
            gx = Stencil5Lanes.apply(gy, ctx.coefs[:, list(_MIRROR)])
        if ctx.needs_input_grad[1]:
            gc = torch.stack([torch.sum(gy * _shift(xb, *sh), dim=(-2, -1))
                              for sh in _COEF_SHIFTS], dim=1).to(ctx.coefs.dtype)
        return gx, gc

    @staticmethod
    def jvp(ctx, gx, gc):
        (xb,) = ctx.saved_tensors
        out = None
        if gx is not None:
            Stencil5Grid.rule_applications["tangent"] += 1
            out = Stencil5Lanes.apply(gx, ctx.coefs)
        if gc is not None:
            gc = gc.to(xb.dtype)
            for k, sh in enumerate(_COEF_SHIFTS):
                term = gc[:, k, None, None] * _shift(xb, *sh)
                out = term if out is None else out + term
        return out


def stencil5_grid(x: torch.Tensor, coefs=None) -> torch.Tensor:
    """``Stencil5Grid`` on a full (N, N) grid, any device: the K1 route of
    the card with its autograd and ``torch.func`` rules (the plain version
    under the same rules on a CPU tensor)."""
    return Stencil5Grid.apply(x, *_coef_terms(coefs))


@row_blocks
def stencil_5pt_pallas(x: torch.Tensor, coefs=None) -> torch.Tensor:
    """Stencil on a full (N, N) grid with zero (Dirichlet) halos: the plain
    version for a CPU tensor (differentiable as plain torch, as gmres_tpu's
    jnp stencil is), K1 for a CUDA tensor. There, where autograd,
    forward-mode AD or a torch.func transform tracks x or a coefficient,
    the launch goes through ``stencil5_grid`` (differentiable by its rules);
    otherwise straight to the wrapper, without the autograd.Function's host
    cost. A tensor coefficient stays in the graph on both devices. A DTensor
    goes by the DTensor route (module docstring): K1's halo form on each
    rank's block on the card. Under ``torch.func.vmap`` (x or a coefficient
    batched) the call goes through ``Stencil5Grid``'s vmap rule on either
    device: one call of this function on the lanes' (lanes, rows, cols)
    block, routed as a grid is (one K1 launch on the card), where
    ``coefs`` may also be a (lanes, 5) tensor, one set a lane; nested vmap
    levels (each lane a block of s grids) are one block of lanes·s grids.
    ``stencil_5pt_pallas.block_calls`` counts calls on a block."""
    if _per_lane(coefs):
        return _k1_per_lane(x, coefs)
    terms = _coef_terms(coefs)
    if on_sharded_grid(x):
        return _halo_route(x, "5pt", terms)
    if _cuda.vmapped(x, *terms):
        return _cuda.through_lanes(_k1_lanes, Stencil5Grid, x, *terms)
    stencil_5pt_pallas.block_calls += int(x.dim() >= 3)
    if x.device.type == "cpu":
        return stencil_5pt_general(x, *terms)
    if x.dim() > 3:
        return stencil_5pt_pallas(_flat_lanes(x), terms).reshape(x.shape)
    if _cuda.tracked_by(x) is None and all(_cuda.tracked_by(c) is None for c in terms):
        return stencil5_cuda(x, None, None, terms)
    return Stencil5Grid.apply(x, *terms)


stencil_5pt_pallas.block_calls = 0


def _flat_lanes(t):
    """A (lanes, s, …, rows, cols) block as one (lanes·s·…, rows, cols)
    block (a view where it can be), for one launch; None stays None."""
    if t is None or t.dim() <= 3:
        return t
    return t.reshape((-1,) + tuple(t.shape[-2:]))


def _k1_per_lane(xb: torch.Tensor, coefs: torch.Tensor) -> torch.Tensor:
    """``stencil_5pt_pallas`` on a (lanes, rows, cols) block with a (lanes, 5)
    tensor of coefficients, one set a lane (each rounded to the block's
    dtype, as a launch rounds it): the plain version for a CPU block
    (differentiable as plain torch), one K1 launch for a CUDA block, through
    ``Stencil5Lanes`` where autograd, forward-mode AD or a torch.func
    transform tracks the block or the coefficients. A (lanes, s, rows,
    cols) block (each lane a block of s grids) is one launch on its
    lanes·s grids, each lane's coefficients repeated down its s grids."""
    stencil_5pt_pallas.block_calls += 1
    if xb.device.type == "cpu":
        return _per_lane_apply(xb, coefs)
    lead = xb.shape[:-2]
    flat = xb.reshape((-1,) + tuple(xb.shape[-2:]))
    if lead.numel() != coefs.shape[0]:
        coefs = coefs.repeat_interleave(lead.numel() // coefs.shape[0], dim=0)
    if _cuda.tracked_by(flat) is not None or _cuda.tracked_by(coefs) is not None:
        return Stencil5Lanes.apply(flat, coefs).reshape(xb.shape)
    return stencil5_cuda(flat, None, None, coefs).reshape(xb.shape)


def _per_lane_apply(xb: torch.Tensor, coefs: torch.Tensor) -> torch.Tensor:
    """The per-lane application itself: the plain version on a CPU block
    (the coefficients broadcast down each lane's grids), one K1 launch on a
    CUDA (lanes, rows, cols) block."""
    if xb.device.type == "cpu":
        c = coefs.to(device=xb.device, dtype=xb.dtype)
        shape = (c.shape[0],) + (1,) * (xb.dim() - 1)
        return stencil_5pt_general(xb, *(c[:, k].reshape(shape) for k in range(5)))
    # A rule's cotangent or tangent block may arrive as a strided view.
    return stencil5_cuda(xb.contiguous(), None, None, coefs)


# The TPU's row-blocked variant exists for VMEM; K1 takes any grid in one
# launch, so the blocked entry point is the same function.
stencil_5pt_pallas_blocked = stencil_5pt_pallas


@row_blocks
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
    return dd_from_f64(stencil_5pt_general(x, *_coef_terms(coefs)))


def _check_pair(x_hi: torch.Tensor, x_lo: torch.Tensor, what: str) -> None:
    _cuda.check_grid(what, "K6", x_hi, x_lo)
    for t in (x_hi, x_lo):
        if t.dtype != torch.float32:
            raise TypeError(f"{what}: a pair is two float32 tensors, not {t.dtype}")
    if x_hi.shape != x_lo.shape or x_hi.device != x_lo.device:
        raise ValueError(f"{what}: hi and lo differ in shape or device")


def stencil5_dd_cuda(x_hi: torch.Tensor, x_lo: torch.Tensor, coefs=None):
    """Launch K6 on a CUDA (hi, lo) float32 pair; returns the result pair.
    ``stencil5_dd_cuda.launches`` counts launches."""
    c = _coef_list(coefs, "stencil5_dd_cuda", "K6")
    _check_pair(x_hi, x_lo, "stencil5_dd_cuda")
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
