#!/usr/bin/env python3
"""gmres_tpu's counts for the solver rows of chip_smoke.py's phase 28 (c), on
the CPU.

    JAX_PLATFORMS=cpu python3 scripts/jax_phase28_counts.py [ROW ...]

Runs the JAX package (the reference; float64 on, CPU backend, one device)
on each row's configuration with the halo route's operators on a one-device
mesh, each solver handed the block placed ``P(None, "grid", None)`` as
the port's rows are, on chip_smoke.py's own numpy inputs (``p28_inputs``),
and prints one JSON line per row. chip_smoke.py imports no JAX, so it
carries these numbers as constants (its JAX_PHASE28 table). Rows:
block_cg (halo operator + halo cbpr2, float64), lobpcg (halo operator, halo
cbpr2 as M), nystrom (the build on the halo operator; λ̂'s ends, its own
sketch) and block_cg_rdma (the RDMA operator and cbpr2 in interpret mode,
float32; ~2 s an application at 1024², so this row takes the longest).
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
from chip_smoke import (  # noqa: E402
    P28_BCG_F32_TOL,
    P28_BCG_TOL,
    P28_LOBPCG,
    P28_N,
    P28_NYSTROM_RANK,
    REF_EIG,
    p28_inputs,
)
from gmres_tpu.parallel.halo import (  # noqa: E402
    halo_chebyshev_preconditioner,
    halo_poisson_operator,
    rdma_chebyshev_preconditioner,
    rdma_stencil_operator,
)
from gmres_tpu.parallel.mesh import shard_grid_vector, solver_mesh  # noqa: E402

MESH = solver_mesh(1)


def block(a):
    return jax.device_put(jnp.asarray(a), NamedSharding(MESH, P(None, "grid", None)))


def rows():
    op = halo_poisson_operator(MESH)
    cbpr2 = halo_chebyshev_preconditioner(MESH, *REF_EIG)

    def block_cg():
        r = jax.jit(lambda b: gt.block_cg(op, b, tol=P28_BCG_TOL, M=cbpr2))(
            block(p28_inputs("bcg")))
        return {"iterations": int(r.iterations), "status": int(r.status)}

    def lobpcg():
        k, tol, cap = P28_LOBPCG
        r = gt.lobpcg(op, block(p28_inputs("lobpcg")), tol=tol, max_iterations=cap, M=cbpr2)
        return {"iterations": int(r.iterations), "status": int(r.status),
                "converged": bool(r.converged),
                "eigenvalues": np.asarray(r.eigenvalues).tolist()}

    def nystrom():
        _, lam = gt.nystrom_preconditioner(
            op, shard_grid_vector(jnp.zeros((P28_N, P28_N)), MESH), rank=P28_NYSTROM_RANK)
        lam = np.asarray(lam)
        return {"lam_ends": [float(lam[-1]), float(lam[0])]}

    def block_cg_rdma():
        a = rdma_stencil_operator(MESH, interpret=True)
        m = rdma_chebyshev_preconditioner(MESH, *REF_EIG, interpret=True)
        r = jax.jit(lambda b: gt.block_cg(a, b, tol=P28_BCG_F32_TOL, M=m))(
            block(p28_inputs("bcg_f32")))
        return {"iterations": int(r.iterations), "status": int(r.status)}

    return {"block_cg": block_cg, "lobpcg": lobpcg, "nystrom": nystrom,
            "block_cg_rdma": block_cg_rdma}


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
