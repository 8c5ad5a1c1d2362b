"""The sparse formats of the PyTorch port against gmres_tpu: the host-side
constructors (equal arrays), the plain SpMVs, the CPU route of kernels K3
and K4 against the Pallas kernels in interpret mode, and the operator
adapter."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gmres_tpu.ops import sparse as jsp
import gmres_tpu_torch as tt
from gmres_tpu_torch.ops import _cuda
from gmres_tpu_torch.ops import sparse as tsp
from tests.torch_parity import rel_err, to_np, to_torch

FIELDS = {
    "CSRMatrix": ("data", "indices", "indptr"),
    "COOMatrix": ("data", "row", "col"),
    "ELLMatrix": ("data", "cols"),
    "DIAMatrix": ("data",),
    "BSRMatrix": ("data", "block_cols"),
}
KIND = {"CSRMatrix": "csr", "COOMatrix": "coo", "ELLMatrix": "ell",
        "DIAMatrix": "dia", "BSRMatrix": "bsr", "HYBMatrix": "hyb"}


def _random_sparse(rng, n, density=0.2):
    a = rng.standard_normal((n, n))
    a[rng.random((n, n)) > density] = 0.0
    np.fill_diagonal(a, np.abs(a).sum(axis=1) + 1.0)
    return a


def _banded_with_stragglers(rng, n=300):
    """Mostly-diagonal matrix with random straggler entries (the structure
    HYB is designed for; tests/test_sparse.py's generator)."""
    dense = np.zeros((n, n))
    for off in (-259, -37, -1, 0, 1, 37, 130):
        dense += np.diag(rng.standard_normal(n - abs(off)), k=off)
    rr = rng.integers(0, n, 200)
    cc = rng.integers(0, n, 200)
    dense[rr, cc] = rng.standard_normal(200)
    return dense


def _tied_band(rng, n=64):
    """Nine diagonals ±k of equal length: with max_diags=4 the choice among
    equal counts falls to numpy's argsort order."""
    dense = np.zeros((n, n))
    for off in (-12, -8, -4, -1, 0, 1, 4, 8, 12):
        dense += np.diag(rng.standard_normal(n - abs(off)), k=off)
    return dense


def _np_fields(m) -> dict:
    """The numpy arrays of a container's fields (either package)."""
    name = type(m).__name__
    if name == "HYBMatrix":
        return {"dia": _np_fields(m.dia),
                "ell": None if m.ell is None else _np_fields(m.ell)}
    return {f: to_np(getattr(m, f)) for f in FIELDS[name]}


def _offsets(m):
    if type(m).__name__ == "HYBMatrix":
        return m.dia.offsets
    return getattr(m, "offsets", None)


def _carry(m, device="cpu"):
    """The very same matrix as a port container (sparse_from_numpy)."""
    return tsp.sparse_from_numpy(KIND[type(m).__name__], _np_fields(m),
                                 m.shape, offsets=_offsets(m), device=device)


def _assert_equal(mt, mj):
    assert type(mt).__name__ == type(mj).__name__
    assert tuple(mt.shape) == tuple(mj.shape)
    assert _offsets(mt) == _offsets(mj)
    ft, fj = _np_fields(mt), _np_fields(mj)
    if "dia" in fj:
        _assert_equal(mt.dia, mj.dia)
        assert (mt.ell is None) == (mj.ell is None)
        if mj.ell is not None:
            _assert_equal(mt.ell, mj.ell)
        return
    for k in fj:
        assert ft[k].dtype == fj[k].dtype, (k, ft[k].dtype, fj[k].dtype)
        np.testing.assert_array_equal(ft[k], fj[k], err_msg=k)


def _case(name):
    rng = np.random.default_rng(40)
    dense = _random_sparse(rng, 32)
    banded = _banded_with_stragglers(rng)
    tied = _tied_band(rng)
    return {
        "csr_from_dense": (lambda p, **kw: p.csr_from_dense(dense, **kw)),
        "coo_from_dense": (lambda p, **kw: p.coo_from_dense(dense, **kw)),
        "ell_from_dense": (lambda p, **kw: p.ell_from_dense(dense, **kw)),
        "dia_from_dense": (lambda p, **kw: p.dia_from_dense(dense, **kw)),
        "bsr_from_dense": (lambda p, **kw: p.bsr_from_dense(dense, 8, **kw)),
        "poisson_csr": (lambda p, **kw: p.poisson_csr(12, **kw)),
        "poisson_dia": (lambda p, **kw: p.poisson_dia(12, **kw)),
        "csr_to_ell": (lambda p, **kw: p.csr_to_ell(p.csr_from_dense(dense, **kw))),
        "csr_to_hyb": (lambda p, **kw: p.csr_to_hyb(p.csr_from_dense(banded, **kw))),
        "csr_to_hyb_max_diags_ties": (lambda p, **kw: p.csr_to_hyb(
            p.csr_from_dense(tied, **kw), max_diags=4)),
        "csr_to_hyb_all_residue": (lambda p, **kw: p.csr_to_hyb(
            p.csr_from_dense(dense, **kw), min_occupancy=1.01)),
        "coo_to_hyb": (lambda p, **kw: p.coo_to_hyb(p.coo_from_dense(banded, **kw))),
        "poisson_hyb": (lambda p, **kw: p.csr_to_hyb(p.poisson_csr(16, **kw))),
    }[name]


CASES = ["csr_from_dense", "coo_from_dense", "ell_from_dense", "dia_from_dense",
         "bsr_from_dense", "poisson_csr", "poisson_dia", "csr_to_ell",
         "csr_to_hyb", "csr_to_hyb_max_diags_ties", "csr_to_hyb_all_residue",
         "coo_to_hyb", "poisson_hyb"]


@pytest.mark.parametrize("name", CASES)
def test_constructors_give_equal_arrays(name):
    """Same numpy code, same split and order: every field is equal to the
    JAX one's, and sparse_from_numpy carries the JAX matrix over unchanged."""
    build = _case(name)
    mj = build(jsp)
    mt = build(tsp, device="cpu")
    _assert_equal(mt, mj)
    _assert_equal(_carry(mj), mj)
    if name == "csr_to_hyb":
        assert mt.ell is not None and len(mt.dia.offsets) == 7
        assert mt.nnz_dia == mj.nnz_dia
    if name == "csr_to_hyb_max_diags_ties":
        assert len(mt.dia.offsets) == 4
    if name == "poisson_hyb":
        assert mt.ell is None and mt.dia.offsets == (-16, -1, 0, 1, 16)


def test_constructor_dtype():
    a = tsp.poisson_csr(6, dtype=torch.float32, device="cpu")
    assert a.data.dtype == torch.float32 and a.indices.dtype == torch.int32
    d = tsp.dia_from_dense(np.eye(5), device="cpu", dtype=torch.float32)
    assert d.data.dtype == torch.float32 and d.offsets == (0,)


def test_entry_points_default_to_the_card():
    """Without a CUDA device, a default call raises instead of building on
    the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    calls = [
        lambda: tt.poisson_matrix(4),
        lambda: tt.poisson_csr(4),
        lambda: tt.poisson_dia(4),
        lambda: tt.csr_from_dense(np.eye(4)),
        lambda: tt.bsr_from_dense(np.eye(4), 2),
        lambda: tt.sparse_from_numpy("ell", {"data": np.ones((4, 1)),
                                             "cols": np.zeros((4, 1))}, (4, 4)),
    ]
    for call in calls:
        with pytest.raises((AssertionError, RuntimeError)):
            call()


def _spmv_pair(name):
    rng = np.random.default_rng(41)
    dense = _random_sparse(rng, 32)
    banded = _banded_with_stragglers(rng)
    mj = {
        "csr": lambda: jsp.csr_from_dense(dense),
        "coo": lambda: jsp.coo_from_dense(dense),
        "ell": lambda: jsp.ell_from_dense(dense),
        "dia": lambda: jsp.dia_from_dense(banded),
        "bsr": lambda: jsp.bsr_from_dense(dense, 8),
        "hyb_residue": lambda: jsp.csr_to_hyb(jsp.csr_from_dense(banded)),
        "hyb_pure_dia": lambda: jsp.csr_to_hyb(jsp.poisson_csr(16)),
    }[name]()
    x = rng.standard_normal(mj.shape[1])
    return mj, x


SPMV = {
    "csr": (jsp.csr_spmv, tsp.csr_spmv),
    "coo": (jsp.coo_spmv, tsp.coo_spmv),
    "ell": (jsp.ell_spmv, tsp.ell_spmv),
    "dia": (jsp.dia_spmv, tsp.dia_spmv),
    "bsr": (jsp.bsr_spmv, tsp.bsr_spmv),
    "hyb_residue": (jsp.hyb_spmv, tsp.hyb_spmv),
    "hyb_pure_dia": (jsp.hyb_spmv, tsp.hyb_spmv),
}


@pytest.mark.parametrize("name", list(SPMV))
def test_plain_spmv_matches_jax(name):
    """float64, the same matrix through sparse_from_numpy: within 1e-12 of
    max|y| (sums in another order; dia_spmv is bitwise in practice)."""
    mj, x = _spmv_pair(name)
    fj, ft = SPMV[name]
    yj = fj(mj, jnp.asarray(x))
    yt = ft(_carry(mj), to_torch(x))
    assert yt.dtype == torch.float64
    assert rel_err(yt, yj) < 1e-12
    if name == "hyb_residue":
        assert mj.ell is not None


def _dia_case(case):
    rng = np.random.default_rng(24)
    n = 300
    offs = {
        "narrow": (-3, -1, 0, 2, 5),
        "wide": (-299, -128, -17, 0, 17, 256, 299),
        "exact128": (-256, -128, 0, 128, 256),
    }[case]
    dense = np.zeros((n, n))
    for off in offs:
        dense += np.diag(rng.standard_normal(n - abs(off)), k=off)
    a = jsp.dia_from_dense(dense)
    assert a.offsets == tuple(sorted(offs))
    return a, rng.standard_normal(n)


@pytest.mark.parametrize("case", ["narrow", "wide", "exact128"])
def test_dia_spmv_pallas_matches_interpret_kernel(case):
    """The port's dia_spmv_pallas on CPU tensors (K3's plain route) against
    the Pallas kernel in interpret mode: lane-only shifts, row+lane shifts
    and offsets on the 128-lane boundary. 1e-15 of max|y|: XLA:CPU may fuse
    the kernel's multiply-add, a last-bit difference."""
    a, x = _dia_case(case)
    yj = jsp.dia_spmv_pallas(a, jnp.asarray(x), interpret=True)
    yt = tsp.dia_spmv_pallas(_carry(a), to_torch(x))
    assert rel_err(yt, yj) < 1e-15
    np.testing.assert_array_equal(to_np(yt), to_np(jsp.dia_spmv(a, jnp.asarray(x))))


def test_dia_spmv_pallas_multiblock_poisson():
    """The Poisson DIA over two Pallas row blocks (block_rows forced), in
    float64 and float32."""
    n = 90
    x = np.random.default_rng(25).standard_normal(n * n)
    for dt, jdt, tol in ((torch.float64, jnp.float64, 1e-15),
                         (torch.float32, jnp.float32, 1e-6)):
        a = jsp.poisson_dia(n, dtype=jdt)
        yj = jsp.dia_spmv_pallas(a, jnp.asarray(x, dtype=jdt), interpret=True,
                                 block_rows=32)
        yt = tsp.dia_spmv_pallas(tsp.poisson_dia(n, dtype=dt, device="cpu"),
                                 to_torch(x).to(dt))
        assert yt.dtype == dt
        assert rel_err(yt, yj) < tol


def test_bsr_spmv_pallas_matches_interpret_kernel():
    """K4's plain route (the einsum) against the Pallas BSR kernel in
    interpret mode, float32, bs = 8, with padding blocks: within 1e-6 of
    max|y| (float32 sums of 4 blocks in another order)."""
    rng = np.random.default_rng(42)
    dense = _random_sparse(rng, 32).astype(np.float32)
    dense[:8, 8:] = 0.0  # block row 0 holds one block: padding in the others
    a = jsp.bsr_from_dense(dense, 8)
    assert int(np.asarray(a.block_cols)[0, -1]) == 0
    x = rng.standard_normal(32).astype(np.float32)
    yj = jsp.bsr_spmv_pallas(a, jnp.asarray(x), interpret=True)
    yt = tsp.bsr_spmv_pallas(_carry(a), to_torch(x))
    assert yt.dtype == torch.float32
    assert rel_err(yt, yj) < 1e-6
    assert rel_err(yt, dense.astype(np.float64) @ x) < 1e-6


@pytest.mark.parametrize("name", list(SPMV))
def test_sparse_operator_every_format(name):
    """sparse_operator over each format equals the JAX operator on the same
    matrix (1e-12 of max|y|), and an operand on another device raises."""
    mj, x = _spmv_pair(name)
    mt = _carry(mj)
    op = tsp.sparse_operator(mt)
    assert rel_err(op(to_torch(x)), jsp.sparse_operator(mj)(jnp.asarray(x))) < 1e-12
    with pytest.raises(ValueError, match="operand on meta"):
        op(torch.zeros(mj.shape[1], dtype=torch.float64, device="meta"))
    with pytest.raises(TypeError):
        tsp.sparse_operator(np.eye(3))


def test_cpu_tensors_never_reach_the_kernels(monkeypatch):
    """A CPU operand takes the plain versions without building anything,
    and the kernel wrappers refuse a CPU operand."""
    def no_build():
        raise AssertionError("the CUDA library was loaded for a CPU tensor")

    monkeypatch.setattr(_cuda, "load", no_build)
    dia = tsp.poisson_dia(6, device="cpu")
    bsr = tsp.bsr_from_dense(np.eye(8), 4, device="cpu")
    x = torch.ones(36, dtype=torch.float64)
    before = (tsp.dia_spmv_cuda.launches, tsp.bsr_spmv_cuda.launches)
    tsp.sparse_operator(dia)(x)
    tsp.sparse_operator(tsp.csr_to_hyb(tsp.poisson_csr(6, device="cpu")))(x)
    tsp.sparse_operator(bsr)(x[:8])
    assert (tsp.dia_spmv_cuda.launches, tsp.bsr_spmv_cuda.launches) == before
    with pytest.raises(ValueError, match="CUDA tensor"):
        tsp.dia_spmv_cuda(dia, x)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tsp.bsr_spmv_cuda(bsr, x[:8])


def test_sparse_from_numpy_refuses_bad_input():
    with pytest.raises(ValueError, match="out of range"):
        tsp.sparse_from_numpy("csr", {"data": np.ones(2), "indices": np.array([0, 5]),
                                      "indptr": np.array([0, 1, 2])}, (2, 2),
                              device="cpu")
    with pytest.raises(ValueError, match="out of range"):
        tsp.sparse_from_numpy("bsr", {"data": np.ones((1, 1, 2, 2)),
                                      "block_cols": np.array([[1]])}, (2, 2),
                              device="cpu")
    with pytest.raises(ValueError, match="one offset per row"):
        tsp.sparse_from_numpy("dia", {"data": np.ones((2, 3))}, (3, 3),
                              offsets=(0,), device="cpu")
    with pytest.raises(ValueError, match="unknown sparse kind"):
        tsp.sparse_from_numpy("csc", {}, (2, 2), device="cpu")
