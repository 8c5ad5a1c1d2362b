#!/usr/bin/env python3
"""gmres_tpu's counts for the rows of chip_smoke.py's phase 19, on the CPU.

    JAX_PLATFORMS=cpu python3 scripts/jax_phase19_counts.py [ROW ...]

Runs the JAX package (the reference; float64 on, CPU backend) on each row's
configuration, through the same programs (helmholtz, sequence, bratu,
convdiff --solver qmr) and public functions (qmr with the multigrid cycle
and its transpose, lsqr, lsmr) the phase drives in the port, and prints one
JSON line per row with its counts. chip_smoke.py imports no JAX, so it
carries these counts as constants (its JAX_PHASE19 table). Rows:
helmholtz256, helmholtz1024, helmholtz1024_mixed, csl_split512,
csl_split512_gcrodr, csl_complex256, sequence, bratu256,
bratu1024, bratu1024_mixed, qmr_mg1024, convdiff_qmr256_cap, convdiff_qmr32,
lsqr128, lsmr128 (all by default), and convdiff_qmr256 on request. About 7
minutes on 8 CPU cores, half of it the split-CSL rows at 512²; the program's
qmr at its 256² default runs 10000 iterations without converging
(convdiff_qmr256), so chip_smoke.py runs it with --max-iterations
QMR_PROGRAM_CAP (convdiff_qmr256_cap), and converged at 32².
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

import gmres_tpu as gt  # noqa: E402
from benchmarks.cli import main as cli_main  # noqa: E402

# The rows' configurations (chip_smoke.py holds the same values).
HELM_N = 1024
CSL_SPLIT_N = 512
CSL_COMPLEX_N = 256
BRATU_N = 1024
QMR_N = 1024
QMR_PROGRAM_N = 32
QMR_PROGRAM_CAP = 2000
LSQ_N = 128
GAMMA = (0.4, 0.2)


def program(argv):
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "rows.jsonl")
        cli_main(argv + ["--jsonl", path])
        with open(path) as f:
            return [json.loads(line) for line in f]


def counts(rows, *keys):
    """(iterations, restarts or None, the named extras) of each row."""
    return [[r["name"], r["iterations"], r.get("restarts")] + [r.get(k) for k in keys]
            for r in rows]


def rows():
    yield "helmholtz256", lambda: counts(program(["helmholtz"]))
    yield "helmholtz1024", lambda: counts(program(["helmholtz", "--nsize", str(HELM_N)]))
    yield "helmholtz1024_mixed", lambda: counts(program(
        ["helmholtz", "--nsize", str(HELM_N), "--precision", "mixed"]))
    yield "csl_split512", lambda: counts(program(
        ["helmholtz", "--nsize", str(CSL_SPLIT_N), "--precond", "csl", "--precision",
         "split"]), "total_inner")
    yield "csl_split512_gcrodr", lambda: counts(program(
        ["helmholtz", "--nsize", str(CSL_SPLIT_N), "--precond", "csl", "--precision",
         "split", "--solver", "gcrodr"]), "total_inner")
    yield "csl_complex256", lambda: counts(program(
        ["helmholtz", "--nsize", str(CSL_COMPLEX_N), "--precond", "csl"]), "total_inner")
    yield "sequence", lambda: counts(program(["sequence"]), "kh2_factor")
    yield "bratu256", lambda: counts(program(["bratu"]), "newton_steps",
                                     "inner_iterations")
    yield "bratu1024", lambda: counts(program(["bratu", "--nsize", str(BRATU_N)]),
                                      "newton_steps", "inner_iterations")
    yield "bratu1024_mixed", lambda: counts(program(
        ["bratu", "--nsize", str(BRATU_N), "--precision", "mixed"]), "newton_steps",
        "inner_iterations")

    def qmr_mg():
        n = QMR_N
        op = gt.convection_diffusion_operator(n, *GAMMA)
        b = op(jnp.ones((n, n), jnp.float64))
        m = gt.convection_diffusion_multigrid_preconditioner(n, *GAMMA)
        mt = gt.convection_diffusion_multigrid_preconditioner(n, *GAMMA, transpose=True)
        res = jax.jit(lambda bb: gt.qmr(op, bb, tol=1e-9, M=m, MT=mt))(b)
        return int(res.iterations), int(res.status)
    yield "qmr_mg1024", qmr_mg
    # The program at its 256² default ends after 10000 iterations at ‖r‖ 4.93
    # (status 1): chip_smoke.py runs it there capped, and at 32².
    yield "convdiff_qmr256_cap", lambda: counts(program(
        ["convdiff", "--solver", "qmr", "--max-iterations", str(QMR_PROGRAM_CAP)]),
        "residual")
    yield "convdiff_qmr32", lambda: counts(program(
        ["convdiff", "--solver", "qmr", "--nsize", str(QMR_PROGRAM_N)]))

    def lsq(name):
        n = LSQ_N
        op = gt.convection_diffusion_operator(n, *GAMMA)
        b = op(jnp.ones((n, n), jnp.float64))
        res = jax.jit(lambda bb: getattr(gt, name)(op, bb, tol=1e-9))(b)
        return int(res.iterations), int(res.status)
    yield f"lsqr{LSQ_N}", lambda: lsq("lsqr")
    yield f"lsmr{LSQ_N}", lambda: lsq("lsmr")
    yield "convdiff_qmr256", lambda: counts(program(["convdiff", "--solver", "qmr"]))


def main():
    want = set(sys.argv[1:])
    for name, fn in rows():
        if name in want or (not want and name != "convdiff_qmr256"):
            print(json.dumps({name: fn()}), flush=True)


if __name__ == "__main__":
    main()
