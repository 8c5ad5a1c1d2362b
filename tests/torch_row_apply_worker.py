"""One rank of tests/test_torch_row_apply.py's DTensor case.

``run(rank, world, init_file, out_dir, rows)`` joins a gloo process group
of ``world`` CPU processes (rendezvous on ``init_file``), places the
(s, N, N) block ``rows`` on the mesh along its grid rows (``[Shard(1)]``),
applies the Poisson operator (through a wrapper marked as taking the block
whole, ``ops/blas.py:row_blocks``, and through one not marked) and its
``mesh=None`` V-cycle (through a wrapper marked only where the cycle is) to
it through ``ops/blas.py:row_apply`` and writes ``out_dir/rank{rank}.npz``:
the whole results and the types of what each was called with. This module
imports no JAX.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist


def run(rank: int, world: int, init_file: str, out_dir: str, rows: np.ndarray) -> None:
    import gmres_tpu_torch as tt
    from torch.distributed.tensor import Shard, distribute_tensor

    from gmres_tpu_torch.ops.blas import row_apply, row_blocks

    torch.set_num_threads(1)
    mesh = tt.init_multihost(f"file://{init_file}", world, rank, device_type="cpu")
    try:
        n = rows.shape[-1]
        blk = distribute_tensor(torch.as_tensor(rows), mesh, [Shard(1)])
        out = {}
        for key, op, marked in (("", tt.poisson_operator(n), True),
                                ("loop_", tt.poisson_operator(n), False),
                                ("cycle_", tt.poisson_multigrid_preconditioner(n), True)):
            seen = []

            def counted(v, op=op, seen=seen):
                seen.append(type(v).__name__)
                return op(v)

            fn = row_blocks(counted, op) if marked else counted
            out[f"{key}out"] = row_apply(fn, blk).full_tensor().numpy()
            out[f"{key}seen"] = np.array(seen)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()
