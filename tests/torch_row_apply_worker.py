"""One rank of tests/test_torch_row_apply.py's DTensor case.

``run(rank, world, init_file, out_dir, rows)`` joins a gloo process group
of ``world`` CPU processes (rendezvous on ``init_file``), places the
(s, N, N) block ``rows`` on the mesh along its grid rows (``[Shard(1)]``),
applies the Poisson operator to it through ``ops/blas.py:row_apply`` and
writes ``out_dir/rank{rank}.npz``: the whole result and the types of what
the operator was called with. This module imports no JAX.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist


def run(rank: int, world: int, init_file: str, out_dir: str, rows: np.ndarray) -> None:
    import gmres_tpu_torch as tt
    from torch.distributed.tensor import Shard, distribute_tensor

    from gmres_tpu_torch.ops.blas import row_apply

    torch.set_num_threads(1)
    mesh = tt.init_multihost(f"file://{init_file}", world, rank, device_type="cpu")
    try:
        op = tt.poisson_operator(rows.shape[-1])
        seen = []

        def counted(v):
            seen.append(type(v).__name__)
            return op(v)

        blk = distribute_tensor(torch.as_tensor(rows), mesh, [Shard(1)])
        out = row_apply(counted, blk)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), out=out.full_tensor().numpy(),
                 seen=np.array(seen))
    finally:
        dist.destroy_process_group()
