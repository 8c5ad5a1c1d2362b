"""Vector (BLAS-1/2) operations on tensors.

Counterpart of ``gmres_tpu/ops/blas.py``. The JAX module routes basis
contractions around XLA:TPU's slow f64 ``dot``; that route has no reason
to exist here, so ``row_contract``/``row_combine`` are plain
``tensordot`` (cuBLAS on the card, which keeps float32 products in full
float32 as long as ``torch.backends.cuda.matmul.allow_tf32`` is False).

Row-sharded vectors (``DTensor`` with ``[Shard(0)]``, see
``parallel/mesh.py``): the reductions here are where a solver's values
cross from the sharded vectors to its small state (Hessenberg column,
Givens rotations, norms, step lengths). Each returns a plain tensor,
all-reduced over the mesh (``as_plain``): DTensor refuses to combine a
plain tensor with a DTensor in a product, and dispatching the solver's
dozens of tiny per-iteration operations through DTensor would cost host
time for nothing. Everything else a solver does is elementwise on the
vectors and stays sharded. On plain tensors nothing changes.

A basis or a block of vectors (k, *shape) is sharded along the grid rows
too, ``[Shard(1)]`` (JAX's ``P(None, "grid", None)``): ``rows_like`` makes
one, ``gram`` reduces two of them to their (k, l) products with one
all-reduce, and ``_svqb`` takes its Gram so. ``replicate_like`` lifts a
small plain matrix onto a sharded operand's mesh for a local product.
``per_mesh`` places an operator's fixed operand (a halo form, a block of
rows) on a mesh once, in a dict that the operator's closure owns.

The contractions (``gram``, ``row_contract``, ``batched_vdot``) and
``row_combine`` flatten their operands' grid dimensions. Where the grid is
sharded on a dimension that is not the first of those (a (2, N, N) split
stack on ``[Shard(1)]``), DTensor (torch 2.11) refuses to flatten without
a redistribution; so on operands sharded alike they work on each rank's
block, a contraction summing the ranks' parts in one all-reduce
(``mesh_sum``), which is what DTensor does where it can flatten.
"""

from __future__ import annotations

import torch

if torch.distributed.is_available():
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
else:  # a torch built without distributed: no tensor is a DTensor
    DTensor, Partial, Replicate, Shard = (), None, None, None


def is_dtensor(x) -> bool:
    """True for a ``torch.distributed.tensor.DTensor`` (not for a tensor
    that a ``torch.func`` transform wraps around one: ``dtensor_of``)."""
    return isinstance(x, DTensor)


_functorch = getattr(torch._C, "_functorch", None)


def dtensor_of(x):
    """The DTensor that x is, or that the wrappers of ``torch.func``
    transforms around x hold (a DTensor seen inside ``torch.func.vjp``);
    None where there is none."""
    while (_functorch is not None and isinstance(x, torch.Tensor)
           and _functorch.is_functorch_wrapped_tensor(x)):
        x = _functorch.get_unwrapped(x)
    return x if is_dtensor(x) else None


def as_plain(t: torch.Tensor) -> torch.Tensor:
    """A plain tensor holding the whole value of ``t``: a DTensor's
    partial sums are all-reduced over its mesh (one collective), a
    replicated DTensor is unwrapped; a plain tensor is returned as is. A
    DTensor that vmap batches (a block of rows) raises: a reduction over
    the mesh has no block form (``refuse_row_block``)."""
    if is_dtensor(t):
        return t.full_tensor()
    refuse_row_block("a reduction over the mesh", t)
    return t


def mesh_sum(part: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """The sum over like's mesh of every rank's plain ``part`` (one
    all-reduce), a plain tensor."""
    mesh = like.device_mesh
    return as_plain(DTensor.from_local(part, mesh, [Partial()] * mesh.ndim,
                                      run_check=False))


def _local_parts(*ts):
    """The ranks' blocks of ``ts`` where every one is a DTensor sharded on
    one 1-D mesh along the same grid dimension (counted from the end, so a
    (k, *shape) block on ``[Shard(d + 1)]`` matches a vector on
    ``[Shard(d)]``); None otherwise."""
    if not all(is_dtensor(t) for t in ts):
        return None
    mesh, grid_dims = ts[0].device_mesh, set()
    for t in ts:
        (place,) = t.placements if len(t.placements) == 1 else (None,)
        if t.device_mesh != mesh or not isinstance(place, Shard):
            return None
        grid_dims.add(t.ndim - place.dim)
    return [t.to_local() for t in ts] if len(grid_dims) == 1 else None


def rows_like(k: int, like: torch.Tensor, dtype=None) -> torch.Tensor:
    """A zero buffer of k rows shaped like ``like``, (k, *like.shape), in
    ``dtype`` (default like's). For a sharded ``like`` it is a DTensor on the
    same mesh with every sharded dimension moved one along (a
    ``[Shard(0)]`` vector gives a ``[Shard(1)]`` basis), each rank
    allocating its own block only (the grid divides evenly over the mesh,
    as ``shard_grid_vector`` requires)."""
    dtype = like.dtype if dtype is None else dtype
    if not is_dtensor(like):
        return torch.zeros((k,) + tuple(like.shape), dtype=dtype, device=like.device)
    loc = like.to_local()
    blk = torch.zeros((k,) + tuple(loc.shape), dtype=dtype, device=loc.device)
    places = [Shard(p.dim + 1) if isinstance(p, Shard) else p for p in like.placements]
    return DTensor.from_local(blk, like.device_mesh, places, run_check=False)


def _sharded_dim(x) -> int:
    """The dimension a DTensor of this package is sharded along (its one
    ``Shard`` placement on the 1-D grid mesh)."""
    (place,) = x.placements
    return place.dim


def shard_offset(x) -> int:
    """Index, along the sharded dimension, of this rank's first element of a
    row-sharded DTensor (shards are equal, as ``shard_grid_vector``
    requires); 0 for a plain tensor."""
    if not is_dtensor(x):
        return 0
    dim = _sharded_dim(x)
    return x.device_mesh.get_coordinate()[0] * x.to_local().shape[dim]


def shard_rows_like(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A block (k, *like.shape) that every rank holds whole, placed as
    ``rows_like`` places a buffer: each rank keeps its own slice, with no
    communication. ``t`` as it is where ``like`` is plain."""
    if not is_dtensor(like):
        return t
    dim = _sharded_dim(like) + 1
    rows = like.to_local().shape[dim - 1]
    blk = t.narrow(dim, shard_offset(like), rows).contiguous()
    return DTensor.from_local(blk, like.device_mesh, [Shard(dim)], run_check=False)


def place_like(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A tensor ``t`` of ``like``'s shape that every rank holds whole, placed
    as the DTensor ``like`` is on its 1-D mesh: this rank's slice for
    ``[Shard(d)]`` (equal shards), the whole for ``[Replicate()]``, with no
    communication; ``t`` as it is where ``like`` is plain."""
    if not is_dtensor(like):
        return t
    blk = t
    for place in like.placements:
        if isinstance(place, Shard):
            rows = like.to_local().shape[place.dim]
            blk = t.narrow(place.dim, like.device_mesh.get_coordinate()[0] * rows, rows)
    return DTensor.from_local(blk.contiguous(), like.device_mesh, like.placements,
                              run_check=False)


def per_mesh(cache: dict, mesh, make):
    """``make(mesh)``, built once per mesh in ``cache``, a dict that the
    caller's closure owns. The entry is keyed on the mesh's id and holds
    the mesh, so that id is not reused while the entry lives."""
    hit = cache.get(id(mesh))
    if hit is None:
        hit = cache[id(mesh)] = (mesh, make(mesh))
    return hit[1]


def on_local(fn, x: torch.Tensor, *others) -> torch.Tensor:
    """fn on this rank's part of the DTensor x (and of the DTensors among
    ``others``, placed as x is), wrapped back with x's placements, for an fn
    that does not mix entries across x's sharded dimension (a solve along
    another axis, a product from the left of column-sharded rows, an
    elementwise map): no communication. fn(x, *others) where x is plain."""
    if not is_dtensor(x):
        return fn(x, *others)
    local = (o.to_local() if is_dtensor(o) else o for o in others)
    return DTensor.from_local(fn(x.to_local(), *local), x.device_mesh, x.placements,
                              run_check=False)


def replicate_like(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A plain tensor ``t`` as a replicated DTensor on ``like``'s mesh, so a
    product with the sharded ``like`` stays local; ``t`` as it is where
    ``like`` is plain or ``t`` already a DTensor."""
    if is_dtensor(like) and not is_dtensor(t):
        return DTensor.from_local(t, like.device_mesh,
                                  [Replicate()] * like.device_mesh.ndim,
                                  run_check=False)
    return t


def gram(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(R, *shape) × (S, *shape) → (R, S): a_flat @ b_flatᵀ, a plain tensor
    (one all-reduce of the (R, S) partial products on a mesh)."""
    parts = _local_parts(a, b)
    if parts is not None:
        la, lb = parts
        return mesh_sum(la.reshape(la.shape[0], -1) @ lb.reshape(lb.shape[0], -1).T, a)
    return as_plain(a.reshape(a.shape[0], -1) @ b.reshape(b.shape[0], -1).T)


def row_contract(rows: torch.Tensor, v: torch.Tensor,
                 conj: bool = False) -> torch.Tensor:
    """Basis contraction (R, *shape) × (*shape) → (R,): rowsᵢ·v, or
    conj(rowsᵢ)·v with ``conj``. For a complex basis that is taken as
    conj(rows·conj(v)): the same products and sums, without materialising
    the conjugate of the whole basis."""
    parts = _local_parts(rows, v)
    if parts is not None:
        return mesh_sum(_contract(*parts, conj), rows)
    return as_plain(_contract(rows, v, conj))


def _contract(rows: torch.Tensor, v: torch.Tensor, conj: bool) -> torch.Tensor:
    flat = rows.reshape(rows.shape[0], -1)
    if conj and rows.is_complex():
        return (flat @ v.reshape(-1).conj()).conj()
    return flat @ v.reshape(-1)


def row_combine(coefs: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Linear combination (R, *extra) × (R, *shape) → (*extra, *shape):
    out[e] = Σᵢ coefs[i, e]·rowsᵢ (``tensordot(coefs, rows, dims=([0], [0]))``).
    Communication-free on sharded rows: the coefficients are replicated,
    and each rank combines its own block."""
    parts = _local_parts(rows)
    if parts is not None and not is_dtensor(coefs):
        out = torch.tensordot(coefs, parts[0], dims=([0], [0]))
        (place,) = rows.placements
        return DTensor.from_local(out, rows.device_mesh,
                                  [Shard(place.dim - 1 + coefs.ndim - 1)], run_check=False)
    return torch.tensordot(replicate_like(coefs, rows), rows, dims=([0], [0]))


def row_op(fn, rows: torch.Tensor, *cs: torch.Tensor) -> torch.Tensor:
    """fn(rows, *cs) with each plain (R,) c shaped (R, 1, …) to meet the
    (R, *shape) block ``rows`` row by row (``c[i]`` against ``rows[i]``):
    elementwise, so on a sharded block it runs on each rank's block. (Left
    to DTensor, torch 2.11's sharding propagation follows a replicated
    first operand and replicates the result.)"""
    bc = (-1,) + (1,) * (rows.dim() - 1)
    return on_local(lambda t: fn(t, *(c.reshape(bc) for c in cs)), rows)


def complex_from(re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
    """torch.complex(re, im); on DTensors placed alike, on each rank's block
    (DTensor in torch 2.11 has no sharding rule for it)."""
    return on_local(torch.complex, re, im)


def complex_parts(v: torch.Tensor):
    """(re, im) of a complex tensor, each made contiguous (a kernel takes no
    strided view); on a DTensor, each rank's block's."""
    return (on_local(lambda t: t.real.contiguous(), v),
            on_local(lambda t: t.imag.contiguous(), v))


def row_blocks(fn, *parts):
    """fn marked as taking a sharded block of rows whole (returned): on a
    DTensor block, ``row_apply`` then calls it once under
    ``torch.func.vmap``, where it calls an unmarked fn once a row. The
    halo route's operators are marked (``parallel/halo.py:BlockSharded``,
    the plain stencils and the models' operators), as are the distributed
    V-cycles (the ``mesh=`` cycles, and the ``mesh=None`` cycles, which
    take a DTensor on its mesh) and the sparse operators (their rank rows).
    With ``parts``, fn is marked only where every one of them is (fn built
    of them and of elementwise work, such as a composition or a Chebyshev
    semi-iteration)."""
    if all(takes_row_blocks(p) for p in parts):
        fn.takes_row_blocks = True
    return fn


def takes_row_blocks(fn) -> bool:
    """True where fn is marked by ``row_blocks``."""
    return getattr(fn, "takes_row_blocks", False) is True


def _vmapped_dtensor(x) -> bool:
    """True where x is a DTensor that a ``torch.func.vmap`` level batches
    (inside ``row_apply``'s vmap over a sharded block)."""
    batched = False
    while (_functorch is not None and isinstance(x, torch.Tensor)
           and _functorch.is_functorch_wrapped_tensor(x)):
        batched = batched or _functorch.is_batchedtensor(x)
        x = _functorch.get_unwrapped(x)
    return batched and isinstance(x, DTensor)


def refuse_row_block(what: str, *ts) -> None:
    """Raise NotImplementedError where one of ``ts`` is a DTensor that vmap
    batches: ``what`` (a route that reads a rank's block or reduces over
    the mesh) has no block form, and an fn that reaches it must not be
    marked by ``row_blocks`` (row_apply then calls it once a row)."""
    if any(_vmapped_dtensor(t) for t in ts):
        raise NotImplementedError(
            f"{what} has no block form on a sharded block of rows: an operator that "
            "reaches it is applied one row at a time (ops/blas.py:row_apply with an fn "
            "not marked by row_blocks; ROADMAP queue 2)")


def row_apply(fn, rows: torch.Tensor) -> torch.Tensor:
    """fn on each row of the block (JAX's ``jax.vmap(fn)``): on a plain block
    ``torch.func.vmap(fn)``, so that each kernel on fn's path (K1 and its
    V-cycle forms, K2, K3, K4) launches once for all rows through its vmap
    rule (``ops/stencil.py``, ``ops/fused.py``, ``ops/sparse.py``), each row
    with the bits of its own call.

    A DTensor block (s rows of a row-sharded grid, ``[Shard(1)]``) takes the
    same vmap where fn is marked as taking it whole (``row_blocks``), which
    the halo route's operators are (``parallel/halo.py:BlockSharded``): the
    halo operator, every halo form, cbpr2, the RDMA operators, the plain
    stencils and the models' operators on a DTensor make one exchange of
    the s rows' boundary rows and one launch (K1's halo form, K5, K8) for
    the block, each row the bits of its own call, and a Chebyshev
    semi-iteration over one of them one of each a sweep. The distributed
    V-cycle (``precond/multigrid.py:_distributed_cycle``: the ``mesh=``
    cycles, and a ``mesh=None`` cycle on a DTensor) makes one exchange a
    sharded-level application and one all-gather at its replicated level
    for the block, and runs the levels below once under vmap; a sparse
    operator's rank rows (``ops/sparse.py:_RankRows``) make one exchange
    or one all-gather and one K3 or K4 launch. The decision is made before
    fn runs. Still one call of fn a row, on the row's DTensor: a block that
    autograd or forward-mode AD tracks, and an fn that is not marked, such
    as a preconditioner built on a sharded basis (deflation, Nyström:
    reductions over the mesh, which ``refuse_row_block`` guards), a
    composition with one, or an operator of the caller's own."""
    if is_dtensor(rows):
        from gmres_tpu_torch.ops._cuda import tracked_by

        if not takes_row_blocks(fn) or tracked_by(rows) is not None:
            return torch.stack([fn(rows[i]) for i in range(rows.shape[0])])
    return torch.func.vmap(fn)(rows)


def _svqb(w: torch.Tensor, eps: float):
    """One SVQB pass over the s long rows of w: (q, r) with orthonormal rows
    q and w[b] = Σ_a r[a, b]·q[a] (r = S⁻¹, dense). Directions below
    eps·λ_max are clamped and come out as orthonormalised noise with ~zero
    weight."""
    g = gram(w.conj(), w)
    d = torch.sqrt(torch.clamp(torch.diagonal(g).real, min=0.0))
    dinv = torch.where(d > 0, 1.0 / torch.where(d > 0, d, torch.ones_like(d)),
                       torch.zeros_like(d))
    gs = g * dinv[:, None] * dinv[None, :]
    # LAPACK refuses a non-finite input, where JAX's eigh returns NaN: the
    # NaN is put back after, without reading the device.
    finite = torch.isfinite(gs).all()
    lam, u = torch.linalg.eigh(torch.where(finite, gs, torch.zeros_like(gs)))
    lam = torch.where(finite, lam, torch.full_like(lam, float("nan")))
    lmax = torch.clamp(lam[-1], min=eps)
    lam_c = torch.maximum(lam, eps * lmax)
    smat = (dinv[:, None] * u) / torch.sqrt(lam_c)[None, :]
    q = row_combine(smat, w)
    r = (torch.sqrt(lam_c)[:, None] * u.T) * d[None, :]
    return q, r


def _orthonormalize_block(w: torch.Tensor, eps: float):
    """SVQB twice: (q, H) with w[b] = Σ_a H[a, b]·q[a]."""
    q1, r1 = _svqb(w, eps)
    q2, r2 = _svqb(q1, eps)
    return q2, r2 @ r1


def tree_vdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Scalar inner product Σ conj(aᵢ)·bᵢ (0-d tensor)."""
    return as_plain(torch.sum(a.conj() * b))


def tree_norm(a: torch.Tensor) -> torch.Tensor:
    """2-norm ‖a‖₂, real even for complex a."""
    return torch.sqrt(tree_vdot(a, a).real)


def tree_sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a - b


def tree_axpy(alpha: torch.Tensor, x: torch.Tensor,
              y: torch.Tensor) -> torch.Tensor:
    """y + alpha·x."""
    return y + alpha * x


def tree_zeros_like(a: torch.Tensor) -> torch.Tensor:
    return torch.zeros_like(a)


def batched_vdot(pairs) -> torch.Tensor:
    """k inner products Σ conj(aᵢ)·bᵢ stacked into one (k,) tensor, so a
    solver reads all k back from the device at once (and a mesh reduces all
    k in one all-reduce). Each is one ``vdot`` (one read of each operand;
    stacking the operands first would copy them)."""
    pairs = list(pairs)
    parts = _local_parts(*(t for pair in pairs for t in pair))
    if parts is not None:
        local = torch.stack([torch.vdot(a.reshape(-1), b.reshape(-1))
                             for a, b in zip(parts[0::2], parts[1::2])])
        return mesh_sum(local, pairs[0][0])
    return as_plain(torch.stack([torch.vdot(a.reshape(-1), b.reshape(-1))
                                 for a, b in pairs]))
