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
  row-blocked kernels exist for VMEM; K2 has three paths of its own, and
  ``chebk_plan`` picks one from the grid's shape, the number of sweeps and
  the dtype (``chebk_route`` leaves the cluster path out on a card that
  cannot schedule the cluster), so both names reach the same function:

  - ``cluster`` (path A, for ``_chebk_kernel``, fused.py:187): the whole
    grid in the shared memory of one thread-block cluster, a band of rows
    per CTA, one launch. A deep polynomial on a small grid is bound by the
    latency of its dependent sweeps, and a cluster barrier costs more than a
    sweep, so each band also holds ``ghost`` rows of its neighbours and
    swaps them through distributed shared memory only every ``ghost``
    sweeps.
  - ``tiled`` (path B, for ``_chebk_blocked_kernel``, fused.py:388): one
    launch; each CTA runs all k − 1 sweeps on a tile with a (k − 1)-cell
    halo, r and d in registers and z in shared memory, the points outside
    the grid held at zero, and writes the tile's interior. The smoothers of
    the large levels are bound by HBM bytes; this reads r once and writes z
    once.
  - ``sweep`` (path C): one launch per sweep, for what neither fused path
    takes (more than ``CHEBK_MAX_FUSED_STEPS`` sweeps, order 1, shapes
    where it measured faster). Paths A and B are bitwise equal to it.

The recurrence (z ≈ A⁻¹r on the 5-point stencil A):

    d₀ = z₀ = r/θ ;  k−1 times:  d ← a·d + b·(r − A z) ;  z ← z + d

with (θ, a, b) rounded to the tensor's dtype, as the JAX jnp form rounds
them (``gmres_tpu/precond/chebyshev.py:90-91``).

The per-shard kernels of the distributed path, routed the same way (a CPU
tensor takes the plain version, a CUDA tensor of float32 or float64 its
kernel, any other CUDA dtype raises):

* ``chebyshev_poisson_fused`` — K5 (``csrc/cheb2_fused.cu``): cbpr2 as one
  stencil pass over a (rows, N) block with explicit halo rows (None for a
  zero row), z = r·(1/d) + α(r − A(r)·(1/d)), using A(r/d) = A(r)/d.
  ``cheb2_apply`` takes the scalars already rounded by ``cheb2_scalars``,
  as the halo preconditioner holds them.
* ``cg_fused_update`` and ``axpy_dot`` — K7 (``csrc/cg_fused.cu``):
  x+αp, r−α·ap and ‖r−α·ap‖², or y+αx and (y+αx)·z, in one pass. The
  elementwise work is in the input dtype; the products and the sum are
  float32, and the sum is the LOCAL partial (a caller on a mesh
  all-reduces it), as in the JAX kernels. No solver calls them, as in
  JAX: the CG of ``solvers/cg.py`` keeps the JAX solver's operations.
"""

from __future__ import annotations

import functools

import torch

from gmres_tpu_torch.ops import _cuda
from gmres_tpu_torch.ops.stencil import (
    POISSON_COEFS,
    _coef_list,
    _coef_terms,
    _flat_lanes,
    _halo_row,
    _lanes_first,
    _shared_coefs,
    stencil_5pt_general,
    stencil_5pt_halo,
)

# K2's fused paths carry at most this many sweeps as kernel parameters
# (csrc/chebk.cu, kMaxFusedSteps).
CHEBK_MAX_FUSED_STEPS = 128
# Shared memory one CTA may use on an H100 (the opt-in maximum, 227 KB).
CTA_SMEM_BYTES = 232448
CLUSTER_SIZES = (1, 2, 4, 8, 16)
# Window points one thread of the cluster path owns, at most
# (csrc/chebk.cu, kMaxClusterPoints).
CLUSTER_POINTS = 8
# Row chunks one thread of the tiled path owns, at most
# (csrc/chebk.cu, kMaxTileChunks).
TILE_CHUNKS = 4


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


def poly_recurrence(r: torch.Tensor, theta: float, steps, apply) -> torch.Tensor:
    """K2's recurrence with the operator ``apply``: the scalars rounded to
    r's dtype, d = r/θ, z = d, then d ← a·d + b·(r − A z), z ← z + d a
    step. The distributed cycle's sharded levels run it over their halo
    operator."""
    theta_r = _rounded([theta], r.dtype)[0]
    ab = _rounded(steps, r.dtype)
    d = r / theta_r
    z = d
    for s in range(len(ab) // 2):
        az = apply(z)
        d = ab[2 * s] * d + ab[2 * s + 1] * (r - az)
        z = z + d
    return z


def poly_stencil_smoother_plain(
    r: torch.Tensor, theta: float, steps, coefs=POISSON_COEFS
) -> torch.Tensor:
    """The plain PyTorch version of K2 (runs on any device)."""
    c = _coef_terms(coefs)
    return poly_recurrence(r, theta, steps, lambda z: stencil_5pt_general(z, *c))


def chebk_bands(rows: int, csize: int) -> list[tuple[int, int]]:
    """(first row, row count) of each CTA's band on K2's cluster path: the
    first rows % csize bands are one row longer (csrc/chebk.cu, band_of)."""
    base, extra = divmod(rows, csize)
    return [(b * base + min(b, extra), base + (b < extra)) for b in range(csize)]


def cluster_window(rows: int, cols: int, csize: int, ghost: int) -> int:
    """Points of one CTA's window on the cluster path: the longest band and
    ``ghost`` rows of each neighbour band."""
    return (-(-rows // csize) + 2 * ghost) * cols


def cluster_threads(rows: int, cols: int, csize: int, ghost: int) -> int:
    """Threads of one CTA on the cluster path: one a window point, in whole
    warps, at most 512 (a cluster barrier costs more with more threads, and
    512 measured fastest), more only where a thread would otherwise own over
    CLUSTER_POINTS points."""
    window = cluster_window(rows, cols, csize, ghost)
    return 32 * -(-max(min(512, window), -(-window // CLUSTER_POINTS)) // 32)


def cluster_fits(rows: int, cols: int, csize: int, ghost: int, itemsize: int) -> bool:
    """Whether the cluster path can take the grid with these CTAs and ghost
    rows (csrc/chebk.cu, cluster_shape_ok). One CTA's shared memory holds r,
    d and two z buffers of its window and the landing rows (2 parities · 2
    sides · z and d)."""
    window = cluster_window(rows, cols, csize, ghost)
    return (csize in CLUSTER_SIZES and csize <= rows
            and (ghost == 0 if csize == 1 else 1 <= ghost <= rows // csize)
            and window <= CLUSTER_POINTS * 1024
            and (4 * window + 8 * ghost * cols) * itemsize <= CTA_SMEM_BYTES)


def tile_chunks(tile: tuple, nsteps: int, itemsize: int) -> int:
    """16-byte row chunks of the tiled path's window: the tile grown by
    nsteps cells a side, rows padded to whole chunks."""
    per = 16 // itemsize
    return (tile[0] + 2 * nsteps) * -(-(tile[1] + 2 * nsteps) // per)


def tile_threads(tile: tuple, nsteps: int, itemsize: int) -> int:
    """Threads of one CTA on the tiled path: up to TILE_CHUNKS chunks of the
    window each, whole warps, 256 to 512 (the counts that measured best)."""
    n = -(-tile_chunks(tile, nsteps, itemsize) // TILE_CHUNKS)
    return min(512, max(256, 32 * -(-n // 32)))


def tile_fits(tile: tuple, nsteps: int, itemsize: int) -> bool:
    """Whether the tiled path can take this tile at this many sweeps
    (csrc/chebk.cu): the window's chunks within TILE_CHUNKS · 512 threads,
    its two z buffers (r and d stay in registers) within one CTA's shared
    memory."""
    chunks = tile_chunks(tile, nsteps, itemsize)
    return (1 <= nsteps <= CHEBK_MAX_FUSED_STEPS and chunks <= TILE_CHUNKS * 512
            and 2 * 16 * chunks <= CTA_SMEM_BYTES)


def chebk_plan(rows: int, cols: int, nsteps: int, dtype: torch.dtype,
               cluster: bool = True):
    """K2's path for a (rows, cols) grid and ``nsteps`` sweeps (order − 1):
    ``("cluster", (csize, ghost))``, ``("tiled", (tile_rows, tile_cols))``
    or ``("sweep", None)``. Plain Python, no card. ``cluster=False`` leaves
    the cluster path out (a card that cannot schedule the cluster).

    The rules are the H100's path table (PERF.md, from ``chip_smoke.py
    --k2-paths``): a fused path is routed only where it measured faster than
    the per-sweep path. Up to 8 sweeps the tiled path won at every grid
    (smaller tiles up to 300² and 512²). From 9 sweeps on, grids up to 150² take the
    cluster path: 16 CTAs with 4 ghost rows from 64 rows, 4 CTAs with 8 at 32
    rows, one CTA at 16 (where a cluster barrier costs more than it saves);
    float32 grids up to 256² the tiled path; larger grids, and float64 past
    150², the per-sweep path, which measured faster there."""
    item = torch.empty((), dtype=dtype).element_size()
    npts = rows * cols
    if not 1 <= nsteps <= CHEBK_MAX_FUSED_STEPS:
        return ("sweep", None)
    if nsteps <= 8:
        tile = ((8, 32) if npts <= 300 * 300 else (16, 32) if npts <= 512 * 512
                else (32, 128) if item == 4 else (32, 64))
        return ("tiled", tile) if tile_fits(tile, nsteps, item) else ("sweep", None)
    if cluster and npts <= 150 * 150:
        for min_rows, csize, ghost in ((64, 16, 4), (32, 4, 8), (1, 1, 0)):
            if rows >= min_rows and cluster_fits(rows, cols, csize, ghost, item):
                return ("cluster", (csize, ghost))
    if item == 4 and npts <= 256 * 256 and tile_fits((16, 32), nsteps, item):
        return ("tiled", (16, 32))
    return ("sweep", None)


@functools.lru_cache(maxsize=None)
def _cluster_schedulable(f64: bool, rows: int, cols: int, csize: int,
                         threads: int, ghost: int, device: int) -> int:
    """How many such clusters the card can hold at once (queried once per
    shape: cudaOccupancyMaxActiveClusters costs host time)."""
    return _cuda.load().gt_chebk_max_active_clusters(int(f64), rows, cols, csize,
                                                     threads, ghost, device)


def _cluster_args(rows: int, cols: int, param, item: int, device: int):
    """The cluster path's launch arguments, or None where the cluster cannot
    hold the grid or the card cannot schedule it."""
    csize, ghost = param[:2]
    threads = param[2] if len(param) > 2 else cluster_threads(rows, cols, csize, ghost)
    if (cluster_fits(rows, cols, csize, ghost, item)
            and _cluster_schedulable(item == 8, rows, cols, csize, threads, ghost,
                                     device) > 0):
        return (1, csize, threads, ghost)
    return None


def chebk_route(rows: int, cols: int, nsteps: int, dtype: torch.dtype,
                device: int, _path=None):
    """K2's path for a (rows, cols) grid on card ``device``, as
    ``(path, param, kernel arguments)``: ``_path`` where forced (ValueError
    where it cannot take the grid), else ``chebk_plan``'s choice. Where that
    is the cluster path and the card cannot schedule the cluster (a MIG
    slice, a part with smaller GPCs: ``_cluster_schedulable`` gives 0), the
    route is ``chebk_plan``'s choice without it: tiled where a tile fits,
    else per-sweep. All three paths give the per-sweep path's bits, so this
    is a choice between correct kernels, as the reference falls back from
    its whole-grid kernel (gmres_tpu/precond/chebyshev.py:158-172)."""
    item = torch.empty((), dtype=dtype).element_size()
    path, param = _path or chebk_plan(rows, cols, nsteps, dtype)
    if path != "sweep" and not 1 <= nsteps <= CHEBK_MAX_FUSED_STEPS:
        raise ValueError(f"chebk_cuda: the {path} path takes 1 to "
                         f"{CHEBK_MAX_FUSED_STEPS} sweeps, not {nsteps}")
    if path == "cluster":
        args = _cluster_args(rows, cols, param, item, device)
        if args is not None:
            return path, param, args
        if _path is not None:
            raise ValueError(f"chebk_cuda: a cluster of {param[0]} CTAs with "
                             f"{param[1]} ghost rows cannot hold a {(rows, cols)} "
                             f"{dtype} grid")
        path, param = chebk_plan(rows, cols, nsteps, dtype, cluster=False)
    if path == "tiled":
        tile = tuple(param[:2])
        threads = param[2] if len(param) > 2 else tile_threads(tile, nsteps, item)
        if not tile_fits(tile, nsteps, item):
            raise ValueError(f"chebk_cuda: tile {tile} with a {nsteps}-cell halo "
                             f"does not fit one CTA's shared memory and threads")
        return path, param, (2, tile[0], tile[1], threads)
    if path == "sweep":
        return path, param, (0, 0, 0, 0)
    raise ValueError(f"chebk_cuda: unknown path {path!r}")


def _chebk_launch(what: str, r: torch.Tensor, theta: float, steps, c, _path):
    """One K2 launch (one per sweep on the per-sweep path) on a CUDA grid or
    (lanes, rows, cols) block, on the path a lane's shape takes; returns
    (z, path, launches)."""
    if len(steps) % 2:
        raise ValueError("steps must hold (a, b) pairs")
    nsteps = len(steps) // 2
    lanes, rows, cols = (1, *r.shape) if r.dim() == 2 else r.shape
    path, _, args = chebk_route(rows, cols, nsteps, r.dtype, r.device.index, _path)
    out = torch.empty_like(r)
    scratch = d = None
    if path == "sweep" and nsteps >= 2:
        scratch = torch.empty_like(r)
        d = torch.empty_like(r)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    rc = _cuda.entry("gt_chebk", r.dtype)(
        r.data_ptr(), out.data_ptr(), ptr(scratch), ptr(d), lanes, rows, cols, theta,
        _cuda.scalar_array(list(steps), r.dtype), nsteps,
        _cuda.scalar_array(c, r.dtype), *args,
        r.device.index, _cuda.stream_of(r))
    _cuda.check(rc, what)
    return out, path, max(nsteps, 1) if path == "sweep" else 1


def chebk_cuda(r: torch.Tensor, theta: float, steps,
               coefs=POISSON_COEFS, *, _path=None) -> torch.Tensor:
    """Launch K2 on a CUDA (rows, N) grid, or once for all lanes on a
    (lanes, rows, N) block (one (θ, steps, coefficients) for every lane,
    each lane the bits of its own launch), on the path ``chebk_route`` picks
    for one grid's shape (``_path`` forces one, for the tests and
    chip_smoke.py). Counts: ``chebk_cuda.launches`` (1 on a fused path, one
    per sweep, at least one, on the sweep path), ``.launches_by_path`` and
    ``.batched_launches`` (those on a block). Under ``torch.func.vmap``, one
    launch on the lanes' block (``ChebK``'s vmap rule)."""
    if _cuda.vmapped(r):
        return _cuda.through_lanes(_k2_lanes, ChebK, r, theta, tuple(steps), ("cuda", _path),
                                   *_coef_terms(coefs))
    c = _coef_list(coefs, "chebk_cuda", "K2")
    _cuda.check_grid("chebk_cuda", "K2", r, lanes=True)
    out, path, n = _chebk_launch("chebk_cuda", r, theta, steps, c, _path)
    chebk_cuda.launches += n
    chebk_cuda.launches_by_path[path] += n
    chebk_cuda.batched_launches += n if r.dim() == 3 else 0
    return out


chebk_cuda.launches = 0
chebk_cuda.launches_by_path = {"cluster": 0, "tiled": 0, "sweep": 0}
chebk_cuda.batched_launches = 0


def _k2_lanes(dims, n, r, theta, steps, route, *coefs):
    """K2's vmap rule: one ``poly_stencil_smoother_pallas`` call on the
    lanes' block (``route`` "routed"), or one ``chebk_cuda`` launch on it
    (``route`` ("cuda", _path), from ``chebk_cuda``); one coefficient set
    for every lane."""
    _shared_coefs("K2", dims[4:])
    rb = _lanes_first(r, dims[0], n)
    if route == "routed":
        return poly_stencil_smoother_pallas(rb, theta, steps, coefs)
    return chebk_cuda(rb, theta, steps, coefs, _path=route[1])


class ChebK(torch.autograd.Function):
    """K2's routed entries under ``torch.func.vmap``:
    ``ChebK.apply(r, theta, steps, route, *coefs)``, whose vmap rule is
    ``_k2_lanes``; ``_cuda.through_lanes`` takes the same rule without the
    Function where vmap is the only transform. No autograd rule, as K2 has
    none."""

    @staticmethod
    def forward(r, theta, steps, route, *coefs):
        if route == "routed":
            return poly_stencil_smoother_pallas(r, theta, steps, coefs)
        return chebk_cuda(r, theta, steps, coefs, _path=route[1])

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, *args):
        return _k2_lanes(in_dims, info.batch_size, *args), 0


def poly_stencil_smoother_pallas(
    r: torch.Tensor,
    theta: float,
    steps,
    coefs=POISSON_COEFS,
) -> torch.Tensor:
    """Order-k polynomial smoother z ≈ A⁻¹r with the caller's (θ, steps):
    the plain version for a CPU tensor, K2 for a CUDA tensor; r a grid or
    a (lanes, rows, cols) block. Under ``torch.func.vmap``, one call on the
    lanes' block on either device (``ChebK``'s vmap rule; one launch on the
    card); ``poly_stencil_smoother_pallas.block_calls`` counts calls on a
    block."""
    if _cuda.vmapped(r):
        return _cuda.through_lanes(_k2_lanes, ChebK, r, theta, tuple(steps), "routed",
                                   *_coef_terms(coefs))
    poly_stencil_smoother_pallas.block_calls += int(r.dim() >= 3)
    if r.device.type == "cpu":
        return poly_stencil_smoother_plain(r, theta, steps, coefs)
    if r.dim() > 3:
        return chebk_cuda(_flat_lanes(r), theta, steps, coefs).reshape(r.shape)
    return chebk_cuda(r, theta, steps, coefs)


poly_stencil_smoother_pallas.block_calls = 0


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


def cheb2_scalars(d: float, alpha: float, coefs, dtype) -> list[float]:
    """[1/d, α, c0, cw, ce, cs, cn] rounded to ``dtype`` as the JAX kernel
    holds them: d, α and the coefficients in the dtype, 1/d divided there.
    The halo preconditioner rounds them once, when it is built."""
    d_r, alpha_r, *c = _rounded([d, alpha, *_coef_list(coefs)], dtype)
    return _rounded([1.0 / d_r], dtype) + [alpha_r] + c


def cheb2_plain(r, top, bottom, scal) -> torch.Tensor:
    """The plain PyTorch version of K5 on ``cheb2_scalars``, in the JAX
    kernel's operation order (``_cheb_kernel``): z = r·(1/d) + α(r −
    A(r)·(1/d)). A halo row of None is a zero row. A (lanes, rows, N) block
    takes (lanes, 1, N) halo rows, lane ℓ's its own, each lane the bits of
    its own call."""
    inv_d, alpha_r, *c = scal
    ar = stencil_5pt_halo(r, top, bottom, c)
    return r * inv_d + alpha_r * (r - ar * inv_d)


def chebyshev_poisson_fused_plain(r, top, bottom, d, alpha,
                                  coefs=POISSON_COEFS) -> torch.Tensor:
    """The plain PyTorch version of K5 (``cheb2_plain`` with the scalars
    rounded to r's dtype)."""
    return cheb2_plain(r, top, bottom, cheb2_scalars(d, alpha, coefs, r.dtype))


def _cheb2_launch(r, top, bottom, scal) -> torch.Tensor:
    _cuda.check_grid("cheb2_cuda", "K5", r, lanes=True)
    top_p = _halo_row(top, r, "cheb2_cuda", "K5")
    bot_p = _halo_row(bottom, r, "cheb2_cuda", "K5")
    z = torch.empty_like(r)
    lanes = r.shape[0] if r.dim() == 3 else 1
    rc = _cuda.entry("gt_cheb2", r.dtype)(
        r.data_ptr(), top_p, bot_p, z.data_ptr(), lanes, r.shape[-2], r.shape[-1],
        *scal, r.device.index, _cuda.stream_of(r))
    _cuda.check(rc, "cheb2_cuda")
    cheb2_cuda.launches += 1
    cheb2_cuda.batched_launches += int(r.dim() == 3)
    return z


def cheb2_cuda(r, top, bottom, d, alpha, coefs=POISSON_COEFS) -> torch.Tensor:
    """Launch K5 on a CUDA (rows, N) block; ``top``/``bottom`` are the halo
    rows, None for a zero row. On a (lanes, rows, N) block, one launch for
    all lanes with (lanes, 1, N) halo rows, lane ℓ's its own (the halo
    route's block form), each lane the bits of its own launch.
    ``cheb2_cuda.launches`` counts launches, ``.batched_launches`` those on
    a block."""
    _coef_list(coefs, "cheb2_cuda", "K5")  # refuses a tracked coefficient
    return _cheb2_launch(r, top, bottom, cheb2_scalars(d, alpha, coefs, r.dtype))


cheb2_cuda.launches = 0
cheb2_cuda.batched_launches = 0


def cheb2_apply(r, top, bottom, scal) -> torch.Tensor:
    """cbpr2 on a (rows, N) block, or a (lanes, rows, N) block with
    (lanes, 1, N) halo rows, with scalars already rounded by
    ``cheb2_scalars``, routed by device: ``cheb2_plain`` for a CPU tensor,
    K5 for a CUDA tensor. The halo preconditioner's per-application entry."""
    if r.device.type == "cpu":
        return cheb2_plain(r, top, bottom, scal)
    return _cheb2_launch(r, top, bottom, scal)


def chebyshev_poisson_fused(r, top, bottom, d, alpha,
                            coefs=POISSON_COEFS) -> torch.Tensor:
    """Degree-2 Chebyshev (cbpr2) application on a (rows, N) block with
    (N,) or (1, N) halo rows (zeros at the physical boundary; None is a zero
    row): the plain version for a CPU tensor, K5 for a CUDA tensor."""
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


def _check_vectors(what: str, kernel: str, *ts: torch.Tensor) -> None:
    _cuda.refuse_dtensor(what, kernel, *ts)
    _cuda.refuse_transforms(what, kernel, *ts)
    for t in ts:
        if not t.is_cuda:
            raise ValueError(f"{what}: expected CUDA tensors, got {t.device}")
        if (t.shape != ts[0].shape or t.dtype != ts[0].dtype
                or t.device != ts[0].device):
            raise ValueError(f"{what}: operands differ in shape, dtype or device")
        if not t.is_contiguous():
            raise ValueError(f"{what}: expected contiguous tensors")
    _cuda.suffix(ts[0].dtype)


# K7's grid: 256-thread blocks, at most K7_BLOCKS_PER_SM an SM.
K7_THREADS = 256
K7_BLOCKS_PER_SM = 4
# Counters a device holds for K7, one per stream that has called it.
K7_COUNTER_SLOTS = 1024


def k7_plan(n: int, itemsize: int, aligned: bool, sms: int) -> tuple[int, int]:
    """(vector width, blocks) of a K7 launch over ``n`` elements of
    ``itemsize`` bytes on a card of ``sms`` SMs: 16-byte chunks where every
    operand is aligned to 16 bytes, one element a step otherwise; a block
    per K7_THREADS chunks, at most K7_BLOCKS_PER_SM an SM, and at least one
    a SM while each still gets a warp's worth of chunks."""
    vec = 16 // itemsize if aligned else 1
    chunks = n // vec
    blocks = min(-(-chunks // K7_THREADS), K7_BLOCKS_PER_SM * sms)
    return vec, max(blocks, min(sms, -(-chunks // 32)), 1)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


_k7_counters: dict = {}


def _k7_counter(device: torch.device, stream: int) -> int:
    """Address of K7's ticket counter for ``stream`` on ``device``. A
    device's counters are one int32 tensor, zeroed when K7 first runs there
    (outside graph capture: a zeroing captured into a graph would run only
    at its replay); a stream takes the next free one, and K7's last block
    leaves it at 0."""
    slab, slots = _k7_counters.get(device.index, (None, None))
    if slab is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("K7's first call on a device must come before "
                               "any CUDA-graph capture of it: its counters are "
                               "zeroed then")
        slab = torch.zeros(K7_COUNTER_SLOTS, dtype=torch.int32, device=device)
        slots = {}
        _k7_counters[device.index] = (slab, slots)
    slot = slots.get(stream)
    if slot is None:
        if len(slots) == K7_COUNTER_SLOTS:
            raise RuntimeError(f"K7: more than {K7_COUNTER_SLOTS} streams on "
                               f"{device}")
        slot = slots[stream] = len(slots)
    return slab.data_ptr() + 4 * slot


def _alpha_arg(alpha, like: torch.Tensor) -> tuple:
    """α as K7 takes it: (pointer, kind, value). A 0-d float32 or float64
    tensor on ``like``'s card is read by pointer (kind 1 or 2); anything else
    by value (kind 0), read on the host (a Python number, or a tensor on the
    CPU) and rounded to the dtype in C."""
    if isinstance(alpha, torch.Tensor) and alpha.is_cuda:
        if alpha.numel() != 1 or alpha.device != like.device:
            raise ValueError(f"alpha must be one value on {like.device}, got "
                             f"shape {tuple(alpha.shape)} on {alpha.device}")
        if alpha.dtype not in (torch.float32, torch.float64):
            alpha = alpha.to(like.dtype)
        return alpha.data_ptr(), 1 if alpha.dtype == torch.float32 else 2, 0.0
    return None, 0, float(alpha)


def _k7_launch(name: str, alpha, tensors) -> torch.Tensor:
    """Launch K7's ``name`` entry on ``tensors`` (its inputs, then its
    outputs, in the entry's order); returns the 0-d float32 sum."""
    like = tensors[0]
    dev = like.device
    aligned = all(t.data_ptr() % 16 == 0 for t in tensors)
    vec, blocks = k7_plan(like.numel(), like.element_size(), aligned,
                          _sm_count(dev.index))
    partial = torch.empty(blocks, dtype=torch.float32, device=dev)
    total = torch.empty((), dtype=torch.float32, device=dev)
    stream = _cuda.stream_of(like)
    rc = _cuda.entry(name, like.dtype)(
        *_alpha_arg(alpha, like), *(t.data_ptr() for t in tensors),
        partial.data_ptr(), _k7_counter(dev, stream), total.data_ptr(),
        like.numel(), vec, blocks, dev.index, stream)
    _cuda.check(rc, name)
    return total


def cg_fused_update_cuda(x, r, p, ap, alpha):
    """Launch K7a on CUDA tensors: one launch, whose last block sums the
    blocks' partials; ``cg_fused_update_cuda.launches`` counts launches."""
    _cuda.refuse_dtensor("cg_fused_update_cuda", "K7a", alpha)
    _cuda.refuse_transforms("cg_fused_update_cuda", "K7a", alpha)
    _check_vectors("cg_fused_update_cuda", "K7a", x, r, p, ap)
    xo, ro = torch.empty_like(x), torch.empty_like(r)
    rsq = _k7_launch("gt_cg_update", alpha, (x, r, p, ap, xo, ro))
    cg_fused_update_cuda.launches += 1
    return xo, ro, rsq


cg_fused_update_cuda.launches = 0


def axpy_dot_cuda(alpha, x, y, z):
    """Launch K7b on CUDA tensors: one launch, whose last block sums the
    blocks' partials; ``axpy_dot_cuda.launches`` counts launches."""
    _cuda.refuse_dtensor("axpy_dot_cuda", "K7b", alpha)
    _cuda.refuse_transforms("axpy_dot_cuda", "K7b", alpha)
    _check_vectors("axpy_dot_cuda", "K7b", x, y, z)
    yn = torch.empty_like(y)
    dot = _k7_launch("gt_axpy_dot", alpha, (x, y, z, yn))
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
