"""The port's checkpoint and debug utilities against gmres_tpu's, on the CPU,
and the port's public surface.

* A checkpoint that ``gmres_tpu.utils.checkpoint`` wrote part-way resumes
  in the port's ``gmres_checkpointed``: the final restart count equals
  JAX's uninterrupted run's and x is within 1e-10 relative; a checkpoint
  the port wrote loads in JAX with the same arrays.
* ``finite_checked`` raises NonFiniteError on a NaN (and passes a finite
  output through unchanged); ``run_checked`` raises on a wrapped operator's
  NaN inside a solve and on a non-finite result.
* ``gmres_tpu_torch.__all__`` holds every name of ``gmres_tpu.__all__``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gmres_tpu as gt
import gmres_tpu_torch as tt
from gmres_tpu.utils import checkpoint as jck
from gmres_tpu_torch.utils import checkpoint as tck
from gmres_tpu_torch.utils import debug as tdebug
from tests.torch_parity import np_poisson, rel_err, seeded, to_np, to_torch

N = 16
KW = {"restart": 5, "tol": 1e-10, "compute_v_err": False}


def test_public_surface_covers_gmres_tpu():
    assert set(gt.__all__) <= set(tt.__all__)
    assert len(set(gt.__all__)) == 101
    for name in gt.__all__:
        assert getattr(tt, name) is not None


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    b = np_poisson(seeded(1, (N, N)))
    path = str(tmp_path / "ck.npz")
    full = gt.gmres(gt.poisson_operator(N), jnp.asarray(b), max_restarts=200, **KW)
    # JAX stops after 2 restarts (its checkpoint holds x and 2).
    part = jck.gmres_checkpointed(gt.poisson_operator(N), jnp.asarray(b),
                                  checkpoint_path=path, chunk_restarts=2, max_restarts=2,
                                  **KW)
    assert int(part.restarts) == 2 and int(jck.load_checkpoint(path)["restarts_done"]) == 2
    res = tck.gmres_checkpointed(tt.poisson_operator(N), to_torch(b), checkpoint_path=path,
                                 chunk_restarts=3, max_restarts=200, **KW)
    assert res.status == int(full.status) == 0
    assert res.restarts == int(full.restarts)
    assert rel_err(res.x, full.x) < 1e-10
    assert int(tck.load_checkpoint(path)["restarts_done"]) == res.restarts


def test_port_checkpoint_loads_in_jax(tmp_path):
    path = str(tmp_path / "port.npz")
    x = seeded(2, (N, N))
    tck.save_checkpoint(path, to_torch(x), 7, meta={"tag": np.int64(3)})
    ck = jck.load_checkpoint(path)
    assert np.array_equal(ck["x"], x) and int(ck["restarts_done"]) == 7
    assert int(ck["tag"]) == 3
    assert tck.load_checkpoint(str(tmp_path / "absent.npz")) is None


def test_exhausted_checkpoint_evaluates_without_iterating(tmp_path):
    b = np_poisson(seeded(3, (N, N)))
    path = str(tmp_path / "ck.npz")
    tck.gmres_checkpointed(tt.poisson_operator(N), to_torch(b), checkpoint_path=path,
                           chunk_restarts=1, max_restarts=1, **KW)
    again = tck.gmres_checkpointed(tt.poisson_operator(N), to_torch(b), checkpoint_path=path,
                                   chunk_restarts=1, max_restarts=1, **KW)
    assert again.restarts == 1


def test_finite_checked_raises_on_nan():
    op = tdebug.finite_checked(lambda v: v / v, "ratio")
    ok = torch.ones(3, dtype=torch.float64)
    assert torch.equal(op(ok), ok)
    with pytest.raises(tdebug.NonFiniteError, match="ratio produced non-finite values"):
        op(torch.zeros(3, dtype=torch.float64))


def test_run_checked_raises_inside_a_solve():
    bad = tdebug.finite_checked(lambda v: v * float("nan"), "preconditioner")
    b = to_torch(np_poisson(seeded(4, (8, 8))))
    with pytest.raises(tdebug.NonFiniteError, match="preconditioner"):
        tdebug.run_checked(tt.cg, tt.poisson_operator(8), b, M=bad)
    res = tdebug.run_checked(tt.cg, tt.poisson_operator(8), b)
    assert res.status == 0
    with pytest.raises(tdebug.NonFiniteError, match=r"\[1\]"):
        tdebug.run_checked(lambda: (b, b * float("inf")))
    assert to_np(tdebug.run_checked(lambda x: x + 1, b)).shape == (8, 8)
