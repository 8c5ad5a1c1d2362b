#!/usr/bin/env python3
"""gmres_tpu's counts for the solver rows of chip_smoke.py's phase 29 (c), on
the CPU.

    JAX_PLATFORMS=cpu python3 scripts/jax_phase29_counts.py [ROW ...]

Runs the JAX package (the reference; float64 on, CPU backend, one device)
on each row's configuration, each solver handed its block placed with the
grid rows along "grid" on a one-device mesh as the port's rows are, on
chip_smoke.py's own numpy inputs (``p29_inputs``), and prints one JSON line
per row. chip_smoke.py imports no JAX, so it carries these numbers as
constants (its JAX_PHASE29 table). Rows: block_cg_mg (block CG with the
``mesh=`` Poisson cycle), lobpcg_mg (LOBPCG with the ``mesh=None`` cycle,
phase 20's rtol) and block_cg_hyb (block CG with cbpr2 on the HYB operator
of the Poisson matrix).
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

import gmres_tpu as gt  # noqa: E402
from chip_smoke import P29_BCG, P29_HYB_BCG, P29_LOBPCG, REF_EIG, p29_inputs  # noqa: E402
from gmres_tpu.parallel.mesh import solver_mesh  # noqa: E402

MESH = solver_mesh(1)


def block(a):
    spec = (None, "grid") + (None,) * (a.ndim - 2)
    return jax.device_put(jnp.asarray(a), NamedSharding(MESH, P(*spec)))


def rows():
    def block_cg_mg():
        n, _, tol = P29_BCG
        op = gt.poisson_operator(n)
        m = gt.poisson_multigrid_preconditioner(n, mesh=MESH)
        r = jax.jit(lambda b: gt.block_cg(op, b, tol=tol, M=m))(block(p29_inputs("bcg")))
        return {"iterations": int(r.iterations), "status": int(r.status)}

    def lobpcg_mg():
        n, _, rtol, cap = P29_LOBPCG
        r = gt.lobpcg(gt.poisson_operator(n), block(p29_inputs("lobpcg")), tol=0.0,
                      rtol=rtol, max_iterations=cap, M=gt.poisson_multigrid_preconditioner(n))
        return {"iterations": int(r.iterations), "status": int(r.status),
                "converged": bool(r.converged),
                "eigenvalues": np.asarray(r.eigenvalues).tolist()}

    def block_cg_hyb():
        n, _, tol = P29_HYB_BCG
        op = gt.sparse_operator(gt.csr_to_hyb(gt.poisson_csr(n)))
        m = gt.chebyshev_preconditioner(op, *REF_EIG)
        r = jax.jit(lambda b: gt.block_cg(op, b, tol=tol, M=m))(block(p29_inputs("bcg_hyb")))
        return {"iterations": int(r.iterations), "status": int(r.status)}

    return {"block_cg_mg": block_cg_mg, "lobpcg_mg": lobpcg_mg, "block_cg_hyb": block_cg_hyb}


def main(argv) -> int:
    table = rows()
    for name in argv or list(table):
        t0 = time.perf_counter()
        out = table[name]()
        print(json.dumps({"row": name, **out, "seconds": time.perf_counter() - t0}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
