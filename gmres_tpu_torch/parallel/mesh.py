"""Device-mesh construction and vector placement.

Counterpart of ``gmres_tpu/parallel/mesh.py``. JAX places a vector on a
mesh and lets GSPMD turn the solvers' reductions into all-reduces and the
stencil's shifts into halo exchanges. PyTorch has no such compiler pass;
its counterpart of a sharded array is the DTensor, and this module makes
the pieces: a 1-D ``DeviceMesh`` named ``"grid"`` over the ranks of the
process group, and grid vectors row-sharded over it (``[Shard(0)]``). The
solvers reduce across ranks through ``ops/blas.py``, and the operators of
``parallel/halo.py`` exchange their halo rows explicitly.

One process drives one device (one rank). A mesh of the CUDA device type
needs an NCCL process group, a CPU mesh a gloo one. ``solver_mesh`` needs
the process group to exist: ``init_multihost`` makes it (one rank or
many), as does ``torch.distributed.init_process_group`` or ``torchrun``.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist

GRID_AXIS = "grid"


def solver_mesh(
    n_devices: Optional[int] = None,
    devices: Optional[Sequence[int]] = None,
    device_type: str = "cuda",
):
    """1-D mesh, axis name "grid", over the ranks ``devices`` (default: every
    rank of the process group), or their first ``n_devices``. Each rank
    drives one device of ``device_type``: the card unless the caller asks
    for "cpu". The process group must exist (see ``init_multihost``)."""
    from torch.distributed.device_mesh import DeviceMesh

    ranks = list(devices if devices is not None else range(dist.get_world_size()))
    if n_devices is not None:
        if n_devices > len(ranks):
            raise ValueError(
                f"requested {n_devices} devices but only {len(ranks)} "
                f"available"
            )
        ranks = ranks[:n_devices]
    return DeviceMesh(device_type, torch.tensor(ranks),
                      mesh_dim_names=(GRID_AXIS,))


def grid_sharding(mesh) -> list:
    """Row-partition an (N, N) grid vector over the mesh: ``[Shard(0)]``."""
    from torch.distributed.tensor import Shard

    return [Shard(0)]


def replicated(mesh) -> list:
    """Every rank holds the whole tensor: ``[Replicate()]``."""
    from torch.distributed.tensor import Replicate

    return [Replicate()]


def shard_grid_vector(x: torch.Tensor, mesh):
    """Place an (N, N) grid vector row-sharded over the mesh (a DTensor; each
    rank keeps N/size rows). N must be divisible by the mesh size (pad the
    grid otherwise). Every rank passes the whole grid; rank 0's is used."""
    from torch.distributed.tensor import distribute_tensor

    n_rows_shards = mesh.size(0)
    if x.shape[0] % n_rows_shards != 0:
        raise ValueError(
            f"grid rows ({x.shape[0]}) must divide evenly across the "
            f"{n_rows_shards}-way '{GRID_AXIS}' mesh axis; pad the "
            f"grid to a multiple of {n_rows_shards} rows (Dirichlet "
            f"zero-padding preserves the operator on the original "
            f"region)"
        )
    return distribute_tensor(x, mesh, grid_sharding(mesh))


def init_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device_type: str = "cuda",
):
    """Join the process group (NCCL for the card, gloo for the CPU) and
    return a 1-D mesh over every rank. Process ``process_id`` of
    ``num_processes`` drives the card numbered process_id modulo the
    host's card count. ``coordinator_address`` is "host:port" (or an
    init-method URL such as "file:///path"); where the three arguments are
    None they come from the environment (MASTER_ADDR, MASTER_PORT,
    WORLD_SIZE, RANK), as ``torch.distributed`` reads it."""
    init_method = coordinator_address
    if init_method is not None and "://" not in init_method:
        init_method = f"tcp://{init_method}"
    if device_type == "cuda":
        rank = process_id if process_id is not None else int(os.environ.get("RANK", 0))
        torch.cuda.set_device(rank % torch.cuda.device_count())
    kwargs = {}
    if num_processes is not None:
        kwargs["world_size"] = num_processes
    if process_id is not None:
        kwargs["rank"] = process_id
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                            init_method=init_method, **kwargs)
    return solver_mesh(device_type=device_type)
