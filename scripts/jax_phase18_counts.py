#!/usr/bin/env python3
"""gmres_tpu's counts for the rows of chip_smoke.py's phase 18, on the CPU.

    JAX_PLATFORMS=cpu python3 scripts/jax_phase18_counts.py [ROW ...]

Runs the JAX package (the reference; float64 on, CPU backend) on each row's
configuration, through the same public functions and programs the phase
drives in the port, and prints one JSON line per row with its counts.
chip_smoke.py imports no JAX, so it carries these counts as constants (its
JAX_PHASE18 table). Rows: multirhs, block_cg, minres,
sstep_cg, chebyshev, chebyshev64, poisson3d, anisotropic, varcoef,
varcoef1024 (all by default). About 10 minutes on 8 CPU cores.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import gmres_tpu as gt  # noqa: E402
from benchmarks.cli import main as cli_main  # noqa: E402
from gmres_tpu.precond.multigrid import poisson3d_multigrid_preconditioner  # noqa: E402
from gmres_tpu.solvers.sstep_cg import sstep_cg  # noqa: E402

# The rows' configurations (chip_smoke.py holds the same values).
MULTIRHS_N = 512
BLOCK_CG_S = 4
POISSON_N = 1024
SSTEP_S = 4
CHEB_ORDER = 512
CHEB_SMALL = (64, 16)
POISSON3D_N = 128
ANISO = (1024, 0.01)
VARCOEF_N = 1024


def program(argv):
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "rows.jsonl")
        cli_main(argv + ["--jsonl", path])
        with open(path) as f:
            return [json.loads(line) for line in f]


def poisson_b(n):
    return gt.poisson_operator(n)(jnp.ones((n, n), jnp.float64))


def rows():
    yield "multirhs", lambda: {r["s"]: r["iterations"] for r in program(
        ["multirhs", "--nsize", str(MULTIRHS_N), "--solver", "block-cg",
         "--s-list", "1,2,4,8"])}

    def block():
        n, s = MULTIRHS_N, BLOCK_CG_S
        op = gt.poisson_operator(n)
        xs = jnp.asarray(np.random.default_rng(0).standard_normal((s, n, n)))
        res = jax.jit(lambda bb: gt.block_cg(
            op, bb, tol=1e-8, M=gt.poisson_multigrid_preconditioner(n),
            max_iterations=2000))(jax.vmap(op)(xs))
        return int(res.iterations), int(res.status)
    yield "block_cg", block

    def poisson_solve(fn):
        n = POISSON_N
        b = poisson_b(n)
        tol = 1e-9 * float(jnp.linalg.norm(b))
        res = jax.jit(lambda bb: fn(gt.poisson_operator(n), bb, tol,
                                    gt.poisson_multigrid_preconditioner(n)))(b)
        return int(res.iterations), int(res.status)
    yield "minres", lambda: poisson_solve(
        lambda op, b, tol, m: gt.minres(op, b, tol=tol, M=m))
    yield "sstep_cg", lambda: poisson_solve(
        lambda op, b, tol, m: sstep_cg(op, b, s=SSTEP_S, tol=tol, M=m))

    def cheb(n, order):
        b = poisson_b(n)
        tol = 1e-9 * float(jnp.linalg.norm(b))
        lo, hi = gt.poisson_spectral_bounds(n)
        res = jax.jit(lambda bb: gt.chebyshev_solve(
            gt.poisson_operator(n), bb, lo, hi, order=order, tol=tol,
            coefs=(4.0, -1.0, -1.0, -1.0, -1.0)))(b)
        return int(res.iterations), int(res.status)
    yield "chebyshev", lambda: cheb(POISSON_N, CHEB_ORDER)
    yield "chebyshev64", lambda: cheb(*CHEB_SMALL)

    def p3d():
        n = POISSON3D_N
        op = gt.poisson3d_operator(n)
        b = op(jnp.ones((n, n, n), jnp.float64))
        res = jax.jit(lambda bb: gt.cg(op, bb, tol=1e-8, max_iterations=400,
                                       M=poisson3d_multigrid_preconditioner(n)))(b)
        return int(res.iterations), int(res.status)
    yield "poisson3d", p3d

    def aniso():
        n, eps = ANISO
        op = gt.anisotropic_operator(n, eps)
        b = op(jnp.ones((n, n), jnp.float64))
        res = jax.jit(lambda bb: gt.cg(
            op, bb, tol=1e-8, M=gt.anisotropic_multigrid_preconditioner(n, eps)))(b)
        return int(res.iterations), int(res.status)
    yield "anisotropic", aniso

    yield "varcoef", lambda: {r["name"]: (r["iterations"], r["l2_error"])
                              for r in program(["varcoef"])}

    def varcoef_mg_defl():
        # benchmarks/cli.py:cmd_varcoef's problem and its mg+defl row.
        n = VARCOEF_N
        c = np.ones((n, n))
        a1 = (slice(n // 6, 5 * n // 12), slice(n // 6, 5 * n // 12))
        a2 = (slice(7 * n // 12, 7 * n // 8), slice(13 * n // 24, 5 * n // 6))
        c[a1] = c[a2] = 1e5
        w = np.zeros((2, n, n))
        w[0][a1] = 1.0
        w[1][a2] = 1.0
        w /= np.linalg.norm(w.reshape(2, -1), axis=1)[:, None, None]
        c = jnp.asarray(c)
        op = gt.varcoef_operator(c)
        x_true = jnp.asarray(np.random.default_rng(0).standard_normal((n, n)))
        b = op(x_true)
        tol = 1e-9 * float(jnp.linalg.norm(b))
        m = gt.coarse_space_preconditioner(op, jnp.asarray(w),
                                           M=gt.varcoef_multigrid_preconditioner(c))
        res = jax.jit(lambda bb: gt.cg(op, bb, tol=tol, max_iterations=20_000, M=m))(b)
        return (int(res.iterations), int(res.status),
                float(jnp.linalg.norm((res.x - x_true).ravel())))
    yield "varcoef1024", varcoef_mg_defl


def main():
    want = set(sys.argv[1:])
    for name, fn in rows():
        if not want or name in want:
            print(json.dumps({name: fn()}), flush=True)


if __name__ == "__main__":
    main()
