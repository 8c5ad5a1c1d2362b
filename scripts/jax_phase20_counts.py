#!/usr/bin/env python3
"""gmres_tpu's counts for the rows of chip_smoke.py's phase 20, on the CPU.

    JAX_PLATFORMS=cpu python3 scripts/jax_phase20_counts.py [ROW ...]

Runs the JAX package (the reference; float64 on, CPU backend) on each row's
configuration, through the same programs (eig with each method, slq,
evolve) and public functions (nystrom_preconditioner under CG,
spai_preconditioner under BiCGSTAB) the phase drives in the port, and prints
one JSON line per row. chip_smoke.py imports no JAX, so it carries these
numbers as constants (its JAX_PHASE20 table). Rows: lobpcg256,
lobpcg1024 (the program at 1024² with --tol 0 and the loosest --rtol of
RTOL_CANDIDATES, from 1e-4 down, at which gmres_tpu converges; the row
records it), arnoldi256, ksreal256, subspace256 (the program's defaults,
γ = (2, 0.5)), arnoldi256_mild, ksreal256_mild, subspace256_mild (the
same at γ = EIG_MILD_GAMMA), slq512, evolve256, evolve256_mg,
evolve256_expm, nystrom512, spai128 (all by default).
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
from chip_smoke import EIG_MILD_GAMMA, np_csr_convdiff  # noqa: E402
from gmres_tpu.models.convection_diffusion import (  # noqa: E402
    convection_diffusion_coefs,
    convection_diffusion_matrix,
)
from gmres_tpu.ops.sparse import CSRMatrix  # noqa: E402

# The rows' configurations (chip_smoke.py holds the same values).
LOBPCG_BIG_N = 1024
RTOL_CANDIDATES = (1e-4, 1e-5, 1e-6)
NYSTROM_N, NYSTROM_RANK, NYSTROM_TOL = 512, 64, 1e-9
SPAI_N, SPAI_GAMMA, SPAI_TOL = 128, (0.4, 0.2), 1e-9


def program(argv):
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "rows.jsonl")
        cli_main(argv + ["--jsonl", path])
        with open(path) as f:
            return [json.loads(line) for line in f]


def pick(rows, *keys):
    """Each row's name, iterations, residual and the named extras."""
    return [{"name": r["name"], "iterations": r["iterations"], "residual": r.get("residual"),
             **{k: r.get(k) for k in keys}} for r in rows]


def convdiff_csr(n, gamma_x, gamma_y):
    """(data, indices, indptr) of the convection-diffusion stencil's matrix
    (chip_smoke.py's own builder)."""
    return np_csr_convdiff(n, convection_diffusion_coefs(gamma_x, gamma_y))


def rows():
    yield "lobpcg256", lambda: pick(program(["eig"]), "converged", "eigenvalues", "linf_error")

    def lobpcg_big():
        for rtol in RTOL_CANDIDATES:
            out = program(["eig", "--nsize", str(LOBPCG_BIG_N), "--tol", "0", "--rtol",
                           str(rtol)])
            if out[0]["converged"]:
                return {"rtol": rtol, "rows": pick(out, "converged", "eigenvalues",
                                                   "linf_error")}
        raise SystemExit("no candidate rtol converged")
    yield "lobpcg1024", lobpcg_big
    for method, key in (("arnoldi", "arnoldi256"), ("ks_real", "ksreal256"),
                        ("subspace", "subspace256")):
        yield key, lambda method=method: pick(program(["eig", "--method", method]),
                                              "converged", "eigenvalues", "linf_error")
    mild = ["--gamma-x", str(EIG_MILD_GAMMA[0]), "--gamma-y", str(EIG_MILD_GAMMA[1])]
    for method, key in (("arnoldi", "arnoldi256_mild"), ("ks_real", "ksreal256_mild"),
                        ("subspace", "subspace256_mild")):
        yield key, lambda method=method: pick(program(["eig", "--method", method] + mild),
                                              "converged", "eigenvalues", "linf_error")
    yield "slq512", lambda: pick(program(["slq"]), "value", "stderr")
    yield "evolve256", lambda: pick(program(["evolve"]), "converged", "iters_step0",
                                    "iters_last")
    yield "evolve256_mg", lambda: pick(program(["evolve", "--precond", "mg"]), "converged",
                                       "iters_step0", "iters_last")
    yield "evolve256_expm", lambda: pick(program(["evolve", "--model", "heat", "--solver",
                                                  "expm"]), "converged")

    def nystrom():
        n = NYSTROM_N
        op = gt.poisson_operator(n)
        b = op(jnp.ones((n, n), jnp.float64))
        m, lam = gt.nystrom_preconditioner(op, jnp.zeros((n, n)), rank=NYSTROM_RANK)
        res = jax.jit(lambda bb: gt.cg(op, bb, tol=NYSTROM_TOL, M=m))(b)
        plain = jax.jit(lambda bb: gt.cg(op, bb, tol=NYSTROM_TOL))(b)
        return {"iterations": int(res.iterations), "status": int(res.status),
                "plain_iterations": int(plain.iterations), "lam_max": float(lam[0]),
                "lam_min": float(lam[-1])}
    yield "nystrom512", nystrom

    def spai():
        n = SPAI_N
        small = convdiff_csr(6, *SPAI_GAMMA)
        dense = np.zeros((36, 36))
        for r in range(36):
            dense[r, small[1][small[2][r]:small[2][r + 1]]] = small[0][small[2][r]:small[2][r + 1]]
        assert np.array_equal(dense, np.asarray(convection_diffusion_matrix(6, *SPAI_GAMMA)))
        data, indices, indptr = convdiff_csr(n, *SPAI_GAMMA)
        csr = CSRMatrix(data=jnp.asarray(data), indices=jnp.asarray(indices),
                        indptr=jnp.asarray(indptr), shape=(n * n, n * n))
        m = gt.spai_preconditioner(csr)
        op = gt.convection_diffusion_operator(n, *SPAI_GAMMA)
        b = op(jnp.ones((n, n), jnp.float64))
        res = jax.jit(lambda bb: gt.bicgstab(op, bb, tol=SPAI_TOL, M=m))(b)
        plain = jax.jit(lambda bb: gt.bicgstab(op, bb, tol=SPAI_TOL))(b)
        return {"iterations": int(res.iterations), "status": int(res.status),
                "plain_iterations": int(plain.iterations)}
    yield "spai128", spai


def main():
    want = set(sys.argv[1:])
    for name, fn in rows():
        if not want or name in want:
            print(json.dumps({name: fn()}), flush=True)


if __name__ == "__main__":
    main()
