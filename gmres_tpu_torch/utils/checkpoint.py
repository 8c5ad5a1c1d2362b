"""Checkpoint and resume at restart boundaries.

Counterpart of ``gmres_tpu/utils/checkpoint.py``: the whole resumable state
of a restarted Krylov solve is (x, restarts done), since the next cycle
rebuilds everything else from the true residual. ``gmres_checkpointed``
runs the solve in chunks of restarts and writes that state to a ``.npz``
file between chunks, in JAX's layout (``x``, ``restarts_done`` and any
metadata), so a checkpoint written by either package resumes in the other.
"""

from __future__ import annotations

import os
from typing import Any, Optional

import numpy as np
import torch

from gmres_tpu_torch.ops.blas import as_plain
from gmres_tpu_torch.solvers.gmres import gmres
from gmres_tpu_torch.types import GmresResult, SolverStatus


def _process_index() -> int:
    dist = torch.distributed
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def save_checkpoint(path: str, x: Any, restarts_done: int,
                    meta: Optional[dict] = None) -> None:
    """Write (x, restarts done) as .npz: rank 0 only, atomically (a
    temporary file renamed over ``path``). A sharded x is gathered first."""
    if isinstance(x, torch.Tensor):
        x = as_plain(x).detach().cpu().numpy()
    if _process_index() != 0:
        return
    tmp = path + ".tmp"
    np.savez(tmp, x=np.asarray(x), restarts_done=np.int64(restarts_done), **(meta or {}))
    # np.savez appends .npz when the name lacks it.
    os.replace(tmp if tmp.endswith(".npz") else tmp + ".npz", path)


def load_checkpoint(path: str) -> Optional[dict]:
    """The checkpoint's arrays by name, or None when ``path`` is absent."""
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def gmres_checkpointed(
    A,
    b: torch.Tensor,
    *,
    checkpoint_path: str,
    chunk_restarts: int = 10,
    max_restarts: int = 1000,
    resume: bool = True,
    **gmres_kwargs,
) -> GmresResult:
    """Restarted GMRES with a checkpoint every ``chunk_restarts`` restart
    cycles (the arguments of ``gmres_tpu.gmres_checkpointed``): the same
    result as ``gmres(..., max_restarts=max_restarts)``, and with ``resume``
    an existing checkpoint at ``checkpoint_path`` continues from its x."""
    gmres_kwargs.pop("x0", None)
    x = None
    done = 0
    if resume:
        ck = load_checkpoint(checkpoint_path)
        if ck is not None:
            x = torch.as_tensor(ck["x"]).to(b.device, b.dtype)
            done = int(ck["restarts_done"])

    result = None
    while done < max_restarts:
        chunk = min(chunk_restarts, max_restarts - done)
        result = gmres(A, b, max_restarts=chunk, x0=x, **gmres_kwargs)
        x = result.x
        done += int(result.restarts)
        save_checkpoint(checkpoint_path, x, done)
        if int(result.status) != SolverStatus.MAX_ITERATIONS:
            break
        if int(result.restarts) == 0:  # converged at x0
            break

    if result is None:
        # Resumed from a checkpoint that had already used max_restarts: the
        # stored x is evaluated without iterating.
        result = gmres(A, b, max_restarts=0, x0=x, **gmres_kwargs)
    return GmresResult(
        x=result.x, iterations=result.iterations, restarts=done,
        residual=result.residual, status=result.status,
        residual_history=result.residual_history, v_err=result.v_err,
        host_syncs=result.host_syncs)
