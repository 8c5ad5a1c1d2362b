"""K2's path choice and the arithmetic of its two fused decompositions, on
the CPU.

``chebk_plan`` is plain Python; its decisions over the multigrid shapes are
pinned here. The CUDA paths cannot run here, so their decompositions are
emulated in plain PyTorch, sweep by sweep, in the kernels' order:

* bands (the cluster path): the rows split by ``chebk_bands``, each band's
  window grown by ``ghost`` rows of each neighbour band, epochs of up to
  ``ghost`` sweeps between exchanges of those rows (one ghost row is one
  exchanged halo row per sweep);
* tiles (the tiled path): windows grown by h = k − 1 cells a side, the
  region shrinking by one cell a side per sweep, the points outside the
  grid held at zero, the interior written.

Both are held bitwise to ``poly_stencil_smoother_plain``, which is what the
card holds the kernels to (against the per-sweep path), and the tiles to
gmres_tpu's row-blocked Pallas kernel in interpret mode."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gmres_tpu.ops import fused as jfu
from gmres_tpu_torch.ops import fused as tfu
from gmres_tpu_torch.ops.stencil import POISSON_COEFS
from tests.torch_parity import rel_err, seeded, to_torch

GENERAL = (4.0, -1.2, -0.8, -1.1, -0.9)
MG_SIZES = (16, 32, 64, 75, 128, 150, 256, 300, 512, 1024, 2048)


def _scalars(theta, steps, dtype):
    return tfu._rounded([theta], dtype)[0], tfu._rounded(steps, dtype)


def _stencil(x, w, e, s, n, c):
    """The kernels' (and the plain version's) order of the five terms."""
    return c[0] * x + c[1] * w + c[2] * e + c[3] * s + c[4] * n


def emulate_bands(r, theta, steps, coefs, csize, ghost):
    """The cluster path's decomposition: each band's window holds its rows
    and ``ghost`` rows of each neighbour band; epochs of up to ``ghost``
    sweeps update the window less k rows at each ghost edge at sweep k, then
    the ghost rows of z and d are refreshed from the neighbours' own rows."""
    theta_r, ab = _scalars(theta, steps, r.dtype)
    c = [float(v) for v in coefs]
    rows = r.shape[0]
    bands = tfu.chebk_bands(rows, csize)
    assert sum(n for _, n in bands) == rows and all(n >= max(ghost, 1) for _, n in bands)
    g = [(ghost if b > 0 else 0, ghost if b + 1 < csize else 0) for b in range(csize)]
    rs = [r[s - gu:s + n + gd] for (s, n), (gu, gd) in zip(bands, g)]
    z = [rw / theta_r for rw in rs]
    d = list(z)
    nsteps, done = len(ab) // 2, 0
    while done < nsteps:
        e = nsteps - done if csize == 1 else min(ghost, nsteps - done)
        for k in range(1, e + 1):
            s = done + k - 1
            for b, (gu, gd) in enumerate(g):
                zw, wr = z[b], z[b].shape[0]
                lo, hi = (k if gu else 0), (wr - k if gd else wr)
                zero = torch.zeros((1, r.shape[1]), dtype=r.dtype)
                ext = torch.cat([zero, zw, zero])
                mid = zw[lo:hi]
                w = torch.nn.functional.pad(mid[:, :-1], (1, 0))
                ea = torch.nn.functional.pad(mid[:, 1:], (0, 1))
                az = _stencil(mid, w, ea, ext[lo:hi], ext[lo + 2:hi + 2], c)
                dn = ab[2 * s] * d[b][lo:hi] + ab[2 * s + 1] * (rs[b][lo:hi] - az)
                d[b] = torch.cat([d[b][:lo], dn, d[b][hi:]])
                z[b] = torch.cat([zw[:lo], mid + dn, zw[hi:]])
        done += e
        if done < nsteps:
            own = [(zb[gu:gu + n], db[gu:gu + n])
                   for zb, db, (gu, _), (_, n) in zip(z, d, g, bands)]
            for b, (gu, gd) in enumerate(g):
                zb, db = z[b], d[b]
                if gu:
                    zb = torch.cat([own[b - 1][0][-gu:], zb[gu:]])
                    db = torch.cat([own[b - 1][1][-gu:], db[gu:]])
                if gd:
                    zb = torch.cat([zb[:-gd], own[b + 1][0][:gd]])
                    db = torch.cat([db[:-gd], own[b + 1][1][:gd]])
                z[b], d[b] = zb, db
    return torch.cat([zb[gu:gu + n] for zb, (gu, _), (_, n) in zip(z, g, bands)])


def emulate_tiles(r, theta, steps, coefs, tile):
    """The tiled path's decomposition: each tile's window of r grown by
    h = nsteps cells a side, zero outside the grid; sweep s updates the
    in-grid points of the window inset by s; the interior is written."""
    theta_r, ab = _scalars(theta, steps, r.dtype)
    c = [float(v) for v in coefs]
    h = len(ab) // 2
    rows, cols = r.shape
    tr, tc = tile
    lr, lc = tr + 2 * h, tc + 2 * h
    out = torch.full_like(r, float("nan"))
    for ti in range(-(-rows // tr)):
        for tj in range(-(-cols // tc)):
            gi0, gj0 = ti * tr - h, tj * tc - h
            gi = torch.arange(gi0, gi0 + lr)[:, None]
            gj = torch.arange(gj0, gj0 + lc)[None, :]
            inside = (gi >= 0) & (gi < rows) & (gj >= 0) & (gj < cols)
            win = torch.zeros((lr, lc), dtype=r.dtype)
            i_lo, i_hi = max(gi0, 0), min(gi0 + lr, rows)
            j_lo, j_hi = max(gj0, 0), min(gj0 + lc, cols)
            win[i_lo - gi0:i_hi - gi0, j_lo - gj0:j_hi - gj0] = r[i_lo:i_hi, j_lo:j_hi]
            zero = torch.zeros_like(win)
            z = torch.where(inside, win / theta_r, zero)
            d = z.clone()
            for s in range(1, h + 1):
                reg = (slice(s, lr - s), slice(s, lc - s))
                az = _stencil(z[reg], z[s:lr - s, s - 1:lc - s - 1],
                              z[s:lr - s, s + 1:lc - s + 1],
                              z[s - 1:lr - s - 1, s:lc - s],
                              z[s + 1:lr - s + 1, s:lc - s], c)
                dn = ab[2 * (s - 1)] * d[reg] + ab[2 * (s - 1) + 1] * (win[reg] - az)
                keep = inside[reg]
                z_new = z.clone()
                z_new[reg] = torch.where(keep, z[reg] + dn, z[reg])
                d[reg] = torch.where(keep, dn, d[reg])
                z = z_new
            o_hi, p_hi = min(tr, rows - ti * tr), min(tc, cols - tj * tc)
            out[ti * tr:ti * tr + o_hi, tj * tc:tj * tc + p_hi] = z[h:h + o_hi, h:h + p_hi]
    return out


def _case(seed, shape, dtype, order, coefs):
    r = to_torch(seeded(seed, shape)).to(dtype)
    if coefs == "general":
        theta, steps = tfu.jacobi_k_scalars(0.7, GENERAL[0], order)
        return r, theta, steps, GENERAL
    lam_min = 8.0 * np.sin(np.pi / (2 * (max(shape) + 1))) ** 2
    theta, _, steps = tfu.chebyshev_k_scalars(lam_min if order > 3 else 2.0, 8.0, order)
    return r, theta, steps, POISSON_COEFS


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape,order,csize,ghost", [
    ((16, 16), 32, 1, 0), ((16, 16), 32, 4, 4), ((75, 75), 32, 16, 4), ((75, 75), 32, 16, 1),
    ((75, 75), 3, 8, 2), ((33, 40), 8, 16, 2), ((75, 30), 3, 2, 8), ((17, 9), 5, 16, 1),
    ((150, 150), 32, 16, 8)])
def test_bands_are_bitwise_the_plain_recurrence(dtype, shape, order, csize, ghost):
    r, theta, steps, coefs = _case(90, shape, dtype, order, "poisson")
    torch.testing.assert_close(emulate_bands(r, theta, steps, coefs, csize, ghost),
                               tfu.poly_stencil_smoother_plain(r, theta, steps, coefs),
                               rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape,order,tile", [
    ((64, 64), 3, (16, 32)), ((64, 64), 8, (32, 32)), ((75, 60), 3, (16, 16)),
    ((30, 97), 4, (8, 32)), ((16, 16), 32, (16, 16)), ((9, 40), 3, (32, 128))])
def test_tiles_are_bitwise_the_plain_recurrence(dtype, shape, order, tile):
    r, theta, steps, coefs = _case(91, shape, dtype, order, "poisson")
    torch.testing.assert_close(emulate_tiles(r, theta, steps, coefs, tile),
                               tfu.poly_stencil_smoother_plain(r, theta, steps, coefs),
                               rtol=0, atol=0)


@pytest.mark.parametrize("decomposition", ["bands", "tiles"])
def test_decompositions_on_general_coefficients(decomposition):
    """Damped Jacobi on a non-symmetric stencil, where a transposed
    neighbour or a swapped halo row would show."""
    r, theta, steps, coefs = _case(92, (40, 52), torch.float32, 6, "general")
    z = (emulate_bands(r, theta, steps, coefs, 4, 3) if decomposition == "bands"
         else emulate_tiles(r, theta, steps, coefs, (16, 32)))
    torch.testing.assert_close(z, tfu.poly_stencil_smoother_plain(r, theta, steps, coefs),
                               rtol=0, atol=0)


def test_tiles_match_blocked_pallas():
    """The tile decomposition against gmres_tpu's row-blocked kernel (its
    own halo and re-mask), in interpret mode at test_plain_matches_blocked_
    pallas's shape; the tolerance is that test's."""
    r = seeded(43, (64, 64), np.float32)
    theta, _, steps = jfu.chebyshev_k_scalars(0.5, 8.0, 3)
    ref = jfu.poly_stencil_smoother_pallas_blocked(jnp.asarray(r), theta, tuple(steps),
                                                   interpret=True, block_rows=16)
    z = emulate_tiles(to_torch(r), theta, steps, POISSON_COEFS, (32, 128))
    assert rel_err(z, ref) < 1e-6


def test_bands_cover_the_rows():
    for rows in (1, 5, 16, 75, 300):
        for csize in tfu.CLUSTER_SIZES:
            if csize > rows:
                continue
            bands = tfu.chebk_bands(rows, csize)
            assert [s for s, _ in bands] == list(np.cumsum([0] + [n for _, n in bands])[:-1])
            assert sum(n for _, n in bands) == rows
            assert max(n for _, n in bands) - min(n for _, n in bands) <= 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_plan_fits_and_is_plain_python(dtype):
    """Every routed fused path fits one CTA's shared memory and the kernels'
    step budget, and nothing above the budget is fused."""
    item = torch.empty((), dtype=dtype).element_size()
    for n in MG_SIZES + (301, 97):
        for nsteps in (0, 1, 2, 7, 31, 127, 128, 129, 199):
            path, param = tfu.chebk_plan(n, n, nsteps, dtype)
            if path == "cluster":
                assert tfu.cluster_fits(n, n, *param, item)
            elif path == "tiled":
                assert tfu.tile_fits(param, nsteps, item)
            else:
                assert (path, param) == ("sweep", None)
            if not 1 <= nsteps <= tfu.CHEBK_MAX_FUSED_STEPS:
                assert path == "sweep"


@pytest.mark.parametrize("n,nsteps,dtype,expected", [
    (16, 31, torch.float32, ("cluster", (1, 0))),    # mg 2048²'s coarse solve
    (75, 31, torch.float32, ("cluster", (16, 4))),   # mg 300²'s coarse solve
    (75, 31, torch.float64, ("cluster", (16, 4))),
    (32, 31, torch.float32, ("cluster", (4, 8))),
    (150, 31, torch.float64, ("cluster", (16, 4))),
    (150, 2, torch.float32, ("tiled", (8, 32))),     # mg 300²'s smoothers
    (300, 2, torch.float64, ("tiled", (8, 32))),
    (2048, 2, torch.float32, ("tiled", (32, 128))),  # mg 2048²'s finest level
    (1024, 2, torch.float64, ("tiled", (32, 64))),
    (4096, 7, torch.float32, ("tiled", (32, 128))),  # the roofline program's order 8
    (300, 7, torch.float32, ("tiled", (8, 32))),
    (512, 2, torch.float32, ("tiled", (16, 32))),    # mg 2048²'s third level
    (512, 7, torch.float64, ("tiled", (16, 32))),
    (256, 31, torch.float32, ("tiled", (16, 32))),
    (300, 31, torch.float32, ("sweep", None)),
    (256, 31, torch.float64, ("sweep", None)),
    (64, 199, torch.float32, ("sweep", None)),
    (300, 0, torch.float32, ("sweep", None)),
])
def test_plan_routes_the_measured_shapes(n, nsteps, dtype, expected):
    """The decisions PERF.md's path table supports, at the shapes measured."""
    assert tfu.chebk_plan(n, n, nsteps, dtype) == expected


@pytest.mark.parametrize("n", [300, 2048])
def test_plan_of_the_mg_cycles(n):
    """The mg configurations run the cluster path for the coarse solve and
    the tiled path for every smoother (chip_smoke.py's phase 4 requires
    both on the card)."""
    from gmres_tpu_torch.precond.multigrid import poisson_multigrid_preconditioner

    plan = poisson_multigrid_preconditioner(n).plan
    smooth = {tfu.chebk_plan(m, m, len(plan.pre_smooth[1]) // 2, torch.float32)[0]
              for m in plan.sizes[:-1]}
    coarse = tfu.chebk_plan(plan.sizes[-1], plan.sizes[-1], len(plan.coarse[1]) // 2,
                            torch.float32)
    assert smooth == {"tiled"} and coarse[0] == "cluster"


def test_wrapper_refuses_a_cpu_tensor_and_routes_it_to_plain():
    r = to_torch(seeded(93, (16, 16)))
    theta, _, steps = tfu.chebyshev_k_scalars(2.0, 8.0, 3)
    with pytest.raises(ValueError, match="CUDA"):
        tfu.chebk_cuda(r, theta, steps)
    torch.testing.assert_close(tfu.poly_stencil_smoother_pallas(r, theta, steps),
                               tfu.poly_stencil_smoother_plain(r, theta, steps),
                               rtol=0, atol=0)
