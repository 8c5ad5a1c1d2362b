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
  the dtype, so both names reach the same function:

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

import functools

import torch

from gmres_tpu_torch.ops import _cuda
from gmres_tpu_torch.ops.stencil import (
    POISSON_COEFS,
    _coef_list,
    _halo_row,
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


def chebk_plan(rows: int, cols: int, nsteps: int, dtype: torch.dtype):
    """K2's path for a (rows, cols) grid and ``nsteps`` sweeps (order − 1):
    ``("cluster", (csize, ghost))``, ``("tiled", (tile_rows, tile_cols))``
    or ``("sweep", None)``. Plain Python, no card.

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
    if npts <= 150 * 150:
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


def chebk_cuda(r: torch.Tensor, theta: float, steps,
               coefs=POISSON_COEFS, *, _path=None) -> torch.Tensor:
    """Launch K2 on a CUDA (rows, N) grid on the path ``chebk_plan`` picks
    (``_path`` forces one, for the tests and chip_smoke.py). Counts:
    ``chebk_cuda.launches`` (1 on a fused path, one per sweep, at least one,
    on the sweep path) and ``chebk_cuda.launches_by_path``."""
    _cuda.check_grid(r, "chebk_cuda")
    if len(steps) % 2:
        raise ValueError("steps must hold (a, b) pairs")
    nsteps = len(steps) // 2
    rows, cols = r.shape
    path, param = _path or chebk_plan(rows, cols, nsteps, r.dtype)
    item = r.element_size()
    if path != "sweep" and not 1 <= nsteps <= CHEBK_MAX_FUSED_STEPS:
        raise ValueError(f"chebk_cuda: the {path} path takes 1 to "
                         f"{CHEBK_MAX_FUSED_STEPS} sweeps, not {nsteps}")
    if path == "cluster":
        csize, ghost = param[:2]
        threads = (param[2] if len(param) > 2
                   else cluster_threads(rows, cols, csize, ghost))
        if (not cluster_fits(rows, cols, csize, ghost, item)
                or _cluster_schedulable(item == 8, rows, cols, csize, threads, ghost,
                                        r.device.index) <= 0):
            raise ValueError(f"chebk_cuda: a cluster of {csize} CTAs with {ghost} "
                             f"ghost rows cannot hold a {tuple(r.shape)} {r.dtype} grid")
        args = (1, csize, threads, ghost)
    elif path == "tiled":
        tile = tuple(param[:2])
        threads = param[2] if len(param) > 2 else tile_threads(tile, nsteps, item)
        if not tile_fits(tile, nsteps, item):
            raise ValueError(f"chebk_cuda: tile {tile} with a {nsteps}-cell halo "
                             f"does not fit one CTA's shared memory and threads")
        args = (2, tile[0], tile[1], threads)
    elif path == "sweep":
        args = (0, 0, 0, 0)
    else:
        raise ValueError(f"chebk_cuda: unknown path {path!r}")
    out = torch.empty_like(r)
    scratch = d = None
    if path == "sweep" and nsteps >= 2:
        scratch = torch.empty_like(r)
        d = torch.empty_like(r)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    fn = getattr(_cuda.load(), f"gt_chebk_{_cuda.suffix(r.dtype)}")
    rc = fn(r.data_ptr(), out.data_ptr(), ptr(scratch), ptr(d), rows, cols, theta,
            _cuda.scalar_array(list(steps), r.dtype), nsteps,
            _cuda.scalar_array(_coef_list(coefs), r.dtype), *args,
            r.device.index, _cuda.stream_of(r))
    _cuda.check(rc, "chebk_cuda")
    n = max(nsteps, 1) if path == "sweep" else 1
    chebk_cuda.launches += n
    chebk_cuda.launches_by_path[path] += n
    return out


chebk_cuda.launches = 0
chebk_cuda.launches_by_path = {"cluster": 0, "tiled": 0, "sweep": 0}


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
