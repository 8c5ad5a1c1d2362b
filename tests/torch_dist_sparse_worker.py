"""One rank of the port's sparse formats on a row-sharded x, for
tests/test_torch_dist_sparse.py.

``run(rank, world, init_file, out_dir, cases)`` joins a gloo process group
of ``world`` CPU processes through ``init_multihost`` (rendezvous on
``init_file``) and applies ``sparse_operator`` of every format to a flat
``[Shard(0)]`` x (the matrix whole on every rank), its collectives counted
by ``CommDebugMode`` and its halo exchanges by ``halo_exchange.exchanges``,
beside the plain product; then gmres_tpu's sharded tests of the formats
(ELL SpMV, CG on a HYB operator) with their arguments.

Each rank writes ``out_dir/rank{rank}.npz``: keys ending ``_rows`` hold its
block along axis 0, every other key a value equal on every rank. This
module imports no JAX.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from tests.torch_dist_models_worker import _counted, _place

N = 16  # tests/test_sparse.py:125 and :317: the 16² Poisson matrix


def matrices(cases: dict) -> dict:
    """Every format, on the CPU: the Poisson matrix as CSR, COO, ELL, DIA
    (band 16) and HYB (no residue); a HYB with a residue; a BSR whose block
    band fits a rank's rows and one whose band does not; a DIA whose band
    does not (the gathering routes)."""
    from gmres_tpu_torch.ops import sparse as sp

    csr = sp.poisson_csr(N, device="cpu")
    return {
        "csr": csr,
        "coo": sp.coo_from_dense(cases["poisson_dense"], device="cpu"),
        "ell": sp.csr_to_ell(csr),
        "dia": sp.poisson_dia(N, device="cpu"),
        "hyb": sp.csr_to_hyb(csr),
        "hyb_residue": sp.csr_to_hyb(sp.csr_from_dense(cases["scattered"], device="cpu")),
        "bsr_band": sp.bsr_from_dense(cases["block_tridiagonal"], 64, device="cpu"),
        "bsr_wide": sp.bsr_from_dense(cases["scattered"], 32, device="cpu"),
        "dia_wide": sp.dia_from_dense(cases["scattered"], device="cpu"),
    }


def run(rank: int, world: int, init_file: str, out_dir: str, cases: dict) -> None:
    import gmres_tpu_torch as tt

    torch.set_num_threads(1)
    mesh = tt.init_multihost(f"file://{init_file}", world, rank, device_type="cpu")
    try:
        out = {}
        x = cases["x"]
        xs = _place(x, mesh)
        for name, a in matrices(cases).items():
            op = tt.sparse_operator(a)
            y = _counted(out, name, lambda: op(xs))
            out[f"{name}_placements"] = np.asarray(str(tuple(y.placements)))
            out[f"{name}_rows"] = y.to_local().numpy()
            out[f"{name}_plain"] = op(torch.as_tensor(x)).numpy()
        _mirrored(mesh, out)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


def _mirrored(mesh, out: dict) -> None:
    """gmres_tpu's sharded tests of the formats, with their arguments."""
    import gmres_tpu_torch as tt

    csr = tt.poisson_csr(N, device="cpu")
    # tests/test_sparse.py:125: ELL SpMV of ones on a row-sharded x.
    ell = tt.sparse_operator(tt.csr_to_ell(csr))
    out["ell_ones_rows"] = ell(_place(np.ones(N * N), mesh)).to_local().numpy()
    # tests/test_sparse.py:317: CG on a HYB operator, b sharded.
    op = tt.sparse_operator(tt.csr_to_hyb(csr))
    b = op(torch.ones(N * N, dtype=torch.float64))
    plain = tt.cg(op, b, tol=1e-10, max_iterations=500)
    res = _counted(out, "hyb_cg", lambda: tt.cg(op, _place(b, mesh), tol=1e-10,
                                                   max_iterations=500))
    out["hyb_cg_counts"] = np.array([res.iterations, res.status])
    out["hyb_cg_plain_counts"] = np.array([plain.iterations, plain.status])
    out["hyb_cg_x_rows"] = res.x.to_local().numpy()
