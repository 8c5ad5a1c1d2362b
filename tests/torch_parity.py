"""Helpers for the parity tests of the PyTorch port (tests/test_torch_*.py).

Each test makes its inputs with numpy from a seed, hands the same arrays
to a ``gmres_tpu`` function (on the CPU, float64 enabled by conftest.py)
and to its ``gmres_tpu_torch`` counterpart, and compares the results as
numpy arrays. Tests that need a CUDA device take the ``cuda_device``
fixture, which skips when there is none; the decision is made when the
test runs, never at import, so every pytest-xdist worker collects the
same tests.
"""

from __future__ import annotations

import contextlib
import os

import numpy as np
import pytest
import torch

# Several pytest-xdist workers share the machine: one intra-op thread each.
torch.set_num_threads(1)


def seeded(seed: int, shape, dtype=np.float64) -> np.ndarray:
    """Standard-normal numpy array from a seed."""
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def to_torch(a, device="cpu") -> torch.Tensor:
    """A numpy (or JAX) array as a torch tensor with its own memory."""
    return torch.as_tensor(np.array(a, copy=True)).to(device)


def to_np(a) -> np.ndarray:
    """A torch tensor or JAX array as a numpy array."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def rel_err(a, b) -> float:
    """max|a − b| / max|b| (max|a − b| when b is all zero)."""
    a, b = to_np(a), to_np(b)
    dt = np.result_type(a, b, np.float64)
    a, b = a.astype(dt), b.astype(dt)
    scale = np.max(np.abs(b)) if b.size else 0.0
    diff = np.max(np.abs(a - b)) if b.size else 0.0
    return float(diff / scale) if scale > 0 else float(diff)


def total_inner(res, m: int) -> int:
    """Inner iterations over all restart cycles of a GMRES result."""
    return (int(res.restarts) - 1) * m + int(res.iterations)


def np_poisson(x: np.ndarray) -> np.ndarray:
    """Independent float64 5-point Laplacian (zero boundaries)."""
    y = 4.0 * x
    y[:, 1:] -= x[:, :-1]
    y[:, :-1] -= x[:, 1:]
    y[1:, :] -= x[:-1, :]
    y[:-1, :] -= x[1:, :]
    return y


def _numpy_of(fn, args):
    """fn(*args) in a spawned process: JAX set up as conftest.py sets it up
    (the CPU, 8 devices, float64), the result's arrays as numpy."""
    import jax

    import tests.conftest  # noqa: F401  (the JAX configuration)

    return jax.tree_util.tree_map(np.asarray, fn(*args))


def gmres_tpu_in_child(fn, *args):
    """Start fn(*args) (a module-level function that runs gmres_tpu) in a
    spawned process, so that it runs beside the caller's own gmres_tpu
    work; returns a function that waits for its result, arrays as numpy."""
    import concurrent.futures
    import multiprocessing

    pool = concurrent.futures.ProcessPoolExecutor(
        1, mp_context=multiprocessing.get_context("spawn"))
    future = pool.submit(_numpy_of, fn, args)
    pool.shutdown(wait=False)
    return future.result


@pytest.fixture
def cuda_device():
    """The first CUDA device; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's CUDA kernels run only on the card)")
    return torch.device("cuda", 0)


@contextlib.contextmanager
def one_rank_mesh(tmp_dir):
    """A one-rank gloo process group in this process (file rendezvous under
    ``tmp_dir``) and the port's CPU mesh over it, destroyed on exit: the
    distributed path with the local block the whole grid."""
    import torch.distributed as dist

    import gmres_tpu_torch as tt

    os.makedirs(tmp_dir, exist_ok=True)
    mesh = tt.init_multihost(f"file://{tmp_dir}/rendezvous", 1, 0, device_type="cpu")
    try:
        yield mesh
    finally:
        dist.destroy_process_group()


def assembled(out_dir, world) -> dict:
    """The outputs of a spawned worker's ranks (``out_dir/rank{r}.npz``):
    keys ending ``_rows`` concatenated along axis 0 and ``_blk`` along axis
    1 (the suffix dropped), every other key equal on every rank."""
    ranks = [np.load(os.path.join(out_dir, f"rank{r}.npz")) for r in range(world)]
    port = {}
    for key in ranks[0].files:
        vals = [z[key] for z in ranks]
        if key.endswith("_rows"):
            port[key[:-5]] = np.concatenate(vals, axis=0)
        elif key.endswith("_blk"):
            port[key[:-4]] = np.concatenate(vals, axis=1)
        else:
            for v in vals[1:]:
                np.testing.assert_array_equal(v, vals[0], err_msg=key)
            port[key] = vals[0]
    return port
