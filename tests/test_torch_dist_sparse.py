"""The port's sparse formats on a row-sharded x, at d = 2 and 4.

Each world size is one spawn of d gloo processes on the CPU
(tests/torch_dist_sparse_worker.py), rendezvous on a file under the test's
temporary directory, every case in the same processes (the two spawns run at
once). ``sparse_operator`` of every format takes a flat ``[Shard(0)]`` x and
returns a ``[Shard(0)]`` y, each rank applying its rows of the matrix, which
every rank holds whole: CSR, COO, ELL and a HYB's ELL residue after one
all-gather of x; DIA, a HYB without residue and a BSR whose band fits a
rank's rows after one halo exchange of the band's entries and no all-gather
(``CommDebugMode``); a DIA or BSR whose band does not fit after one
all-gather. Meanwhile the parent computes gmres_tpu's products on the same
matrices; gmres_tpu's sharded tests of the formats are mirrored with their
arguments.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import gmres_tpu as gt
from gmres_tpu.ops import sparse as jsp
from tests import torch_dist_sparse_worker as worker
from tests.torch_parity import assembled, rel_err

WORLDS = (2, 4)
N = worker.N


def _cases():
    rng = np.random.default_rng(2016)
    n = N * N
    block = np.zeros((n, n))
    for i in range(n // 64):
        for j in (i - 1, i, i + 1):
            if 0 <= j < n // 64:
                block[i * 64:(i + 1) * 64, j * 64:(j + 1) * 64] = rng.standard_normal((64, 64))
    scattered = rng.standard_normal((n, n)) * (rng.random((n, n)) < 0.03) + 4.0 * np.eye(n)
    return {"x": rng.standard_normal(n), "block_tridiagonal": block, "scattered": scattered,
            "poisson_dense": np.asarray(gt.poisson_matrix(N))}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """{world: port outputs} for both world sizes."""
    cases = _cases()
    runs = {}
    try:
        for world in WORLDS:
            out_dir = tmp_path_factory.mktemp(f"dist_sparse_world{world}")
            runs[world] = (out_dir, mp.spawn(
                worker.run, args=(world, os.path.join(out_dir, "rendezvous"),
                                  str(out_dir), cases), nprocs=world, join=False))
    finally:
        for _, ctx in runs.values():
            while not ctx.join():
                pass
    return {world: assembled(out_dir, world) for world, (out_dir, _) in runs.items()}


@pytest.fixture(params=WORLDS, ids=lambda w: f"world{w}")
def port(request, worlds):
    return worlds[request.param]


# (format, all-gathers, exchanges) of one application.
ROUTES = [("csr", 1, 0), ("coo", 1, 0), ("ell", 1, 0), ("dia", 0, 1), ("hyb", 0, 1),
          ("hyb_residue", 1, 0), ("bsr_band", 0, 1), ("bsr_wide", 1, 0), ("dia_wide", 1, 0)]


@pytest.mark.parametrize("name,gathers,exchanges", ROUTES)
def test_format_on_a_sharded_x(port, name, gathers, exchanges):
    """Each format on a [Shard(0)] x: a [Shard(0)] y equal to the plain
    product within 1e-13 relative (the same sums in the same order: the DIA
    and HYB rows to the bit), with the route's all-gathers and exchanges and
    no other collective."""
    y = port[name]
    assert str(port[f"{name}_placements"]) == "(Shard(dim=0),)"
    assert rel_err(y, port[f"{name}_plain"]) <= 1e-13
    if name in ("dia", "hyb"):
        assert np.array_equal(y, port[f"{name}_plain"])
    assert tuple(port[f"{name}_comm"]) == (gathers, 0, gathers)
    assert int(port[f"{name}_exchanges"]) == exchanges


@functools.lru_cache(maxsize=None)
def _jax_product(name):
    """gmres_tpu's plain product of the format ``name`` with x (its numpy
    arrays handed to gmres_tpu's container), jitted (an eager DIA of a few
    hundred diagonals takes ~4× as long), once for both world sizes."""
    cases = _cases()
    a = worker.matrices(cases)[name]
    return np.asarray(jax.jit(jsp.sparse_operator(_to_jax(a)))(jnp.asarray(cases["x"])))


@pytest.mark.parametrize("name", [r[0] for r in ROUTES])
def test_format_matches_gmres_tpu(port, name):
    """The sharded product is gmres_tpu's plain product of the same matrix
    (its numpy arrays handed to gmres_tpu's container) within 1e-13
    relative."""
    assert rel_err(port[name], _jax_product(name)) <= 1e-13


def _to_jax(a):
    """gmres_tpu's container holding the port container's arrays."""
    def arrays(m):
        return {f: jnp.asarray(getattr(m, f).numpy()) for f in
                ("data", "indices", "indptr", "row", "col", "cols", "block_cols")
                if hasattr(m, f)}

    if type(a).__name__ == "HYBMatrix":
        return jsp.HYBMatrix(dia=_to_jax(a.dia), ell=None if a.ell is None else _to_jax(a.ell),
                             shape=a.shape)
    cls = getattr(jsp, type(a).__name__)
    extra = {"offsets": a.offsets} if hasattr(a, "offsets") else {}
    return cls(**arrays(a), shape=a.shape, **extra)


def test_ell_spmv_under_sharding(port):
    """tests/test_sparse.py:125: the ELL SpMV of ones on a row-sharded x is
    the Poisson stencil's within 1e-13 relative (here the matrix stays whole
    on every rank; gmres_tpu shards its rows too)."""
    ref = np.asarray(gt.poisson_apply(jnp.ones((N, N)))).reshape(-1)
    np.testing.assert_allclose(port["ell_ones"], ref, rtol=1e-13)


def test_hyb_cg_on_a_sharded_b(port):
    """tests/test_sparse.py:317: CG on the HYB operator with a row-sharded b
    takes the unsharded run's iterations exactly, x within 1e-7 of ones;
    each application one exchange and no all-gather."""
    it, status = (int(v) for v in port["hyb_cg_counts"])
    assert (it, status) == tuple(int(v) for v in port["hyb_cg_plain_counts"])
    assert status == 0
    np.testing.assert_allclose(port["hyb_cg_x"], 1.0, atol=1e-7)
    assert int(port["hyb_cg_comm"][0]) == 0
    assert int(port["hyb_cg_exchanges"]) == it + 1


def test_band_route_refuses_what_it_cannot_take(tmp_path):
    """A non-square matrix on a row-sharded x raises NotImplementedError; a
    [Replicate()] x is the plain product on the local tensor."""
    import gmres_tpu_torch as tt
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from tests.torch_parity import one_rank_mesh

    rng = np.random.default_rng(3)
    with one_rank_mesh(str(tmp_path)) as mesh:
        x = rng.standard_normal(32)
        rect = tt.sparse_operator(tt.csr_from_dense(rng.standard_normal((16, 32)),
                                                    device="cpu"))
        with pytest.raises(NotImplementedError, match="square"):
            rect(distribute_tensor(torch.as_tensor(x), mesh, [Shard(0)]))
        op = tt.sparse_operator(tt.poisson_dia(4, device="cpu"))
        xr = distribute_tensor(torch.as_tensor(x[:16]), mesh, [Replicate()])
        y = op(xr)
        assert tuple(y.placements) == (Replicate(),)
        assert torch.equal(y.to_local(), op(torch.as_tensor(x[:16])))
