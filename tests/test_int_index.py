"""Int8-plane exact ANN engine (ann/int_index.py): Karatsuba plane-partial
combine identity, float64-oracle top-k parity across shapes/dtypes/limb
counts, tie and padding semantics, db-folder construction."""

import numpy as np
import pytest

from metagenome_vector_sketches_tpu.ops import pairwise as pw
from metagenome_vector_sketches_tpu.ann.int_index import (
    IntExactIndex, _host_planes)


def _oracle_topk(V, Q, k):
    """float64-exact cosine top-k with (descending score, ascending index)
    tie-break — the engine's documented ordering."""
    dots = Q.astype(np.int64) @ V.astype(np.int64).T
    ns = np.einsum("ij,ij->i", V.astype(np.int64), V.astype(np.int64))
    qns = np.einsum("ij,ij->i", Q.astype(np.int64), Q.astype(np.int64))
    denom = np.sqrt(ns[None, :].astype(np.float64)
                    * qns[:, None].astype(np.float64))
    with np.errstate(divide="ignore", invalid="ignore"):
        score = np.where(denom > 0, dots / np.maximum(denom, 1e-300), 0.0)
    D = np.zeros((Q.shape[0], k), np.float64)
    I = np.full((Q.shape[0], k), -1, np.int64)
    kk = min(k, V.shape[0])
    for b in range(Q.shape[0]):
        order = np.lexsort((np.arange(V.shape[0]), -score[b]))[:kk]
        I[b, :kk] = order
        D[b, :kk] = score[b][order]
    return D, I


def test_plane_weights_int_exact_combine():
    rng = np.random.default_rng(0)
    for L in (1, 2, 3):
        lim = 60 if L == 1 else (8000 if L == 2 else 30000)
        v = rng.integers(-lim, lim + 1, size=(5, 96)).astype(np.int32)
        q = rng.integers(-lim, lim + 1, size=(3, 96)).astype(np.int32)
        vp = _host_planes(v, L).astype(np.int64)
        qp = _host_planes(q, L).astype(np.int64)
        parts = np.einsum("pqd,pnd->pqn", qp, vp)      # (P, 3, 5)
        dots = np.einsum("p,pqn->qn", pw.plane_weights_int(L), parts)
        assert np.array_equal(dots, q.astype(np.int64) @ v.astype(np.int64).T)


@pytest.mark.parametrize("n,d,mag,chunk", [
    (37, 64, 300, 16),       # multi-chunk scan, L=2
    (128, 128, 50, 128),     # single chunk, L=1
    (60, 64, 20000, 32),     # int16-range magnitudes, L=3
])
def test_int_index_oracle_topk(n, d, mag, chunk):
    rng = np.random.default_rng(n + d)
    V = rng.integers(-mag, mag + 1, size=(n, d)).astype(np.int32)
    V[2] = 0                                           # zero row
    Q = rng.integers(-mag, mag + 1, size=(7, d)).astype(np.int32)
    idx = IntExactIndex(V, chunk_rows=chunk)
    k = 10
    D, I = idx.search(Q, k)
    oD, oI = _oracle_topk(V, Q, k)
    # compare by score first (distinct-score prefixes must match exactly;
    # at exact-tie boundaries any tied index is acceptable — but the
    # documented tie-break makes them equal anyway)
    assert np.array_equal(I, oI.astype(np.int32)), (I, oI)
    assert np.allclose(D, oD, rtol=1e-6, atol=1e-7)


def test_int_index_duplicate_tie_break():
    rng = np.random.default_rng(3)
    V = rng.integers(-100, 101, size=(20, 32)).astype(np.int32)
    V[7] = V[3]                                        # exact duplicate
    Q = V[3][None]
    idx = IntExactIndex(V, chunk_rows=8)
    D, I = idx.search(Q, 3)
    assert I[0, 0] == 3 and I[0, 1] == 7               # lower index first
    assert D[0, 0] == D[0, 1] == pytest.approx(1.0)


def test_int_index_k_exceeds_ntotal():
    V = np.arange(12, dtype=np.int32).reshape(3, 4) + 1
    idx = IntExactIndex(V)
    D, I = idx.search(np.array([[1, 2, 3, 4]], np.int32), 5)
    assert list(I[0, 3:]) == [-1, -1] and list(D[0, 3:]) == [0.0, 0.0]
    assert set(I[0, :3].tolist()) == {0, 1, 2}


def test_int_index_query_range_guard():
    V = np.ones((4, 8), np.int32) * 50                 # L=1 index
    idx = IntExactIndex(V)
    assert idx.L == 1
    with pytest.raises(ValueError, match="limb range"):
        idx.search(np.full((1, 8), 5000, np.int32), 2)


def test_int_index_rejects_float_vectors():
    with pytest.raises(ValueError, match="integer"):
        IntExactIndex(np.ones((2, 4), np.float32))


def test_int_index_from_dbfolder_matches_arrays(tmp_path):
    from metagenome_vector_sketches_tpu.io.dbfolder import DbFolder
    rng = np.random.default_rng(9)
    n, d = 50, 64
    V = rng.integers(-800, 801, size=(n, d)).astype(np.int32)
    db = DbFolder.write(str(tmp_path / "db"),
                        [f"S{i}" for i in range(n)], V, d)
    Q = rng.integers(-800, 801, size=(4, d)).astype(np.int32)
    a = IntExactIndex(V, chunk_rows=16)
    b = IntExactIndex.from_dbfolder(db.path, chunk_rows=16)
    Da, Ia = a.search(Q, 8)
    Db, Ib = b.search(Q, 8)
    assert np.array_equal(Ia, Ib) and np.array_equal(Da, Db)
    oD, oI = _oracle_topk(V, Q, 8)
    assert np.array_equal(Ia, oI.astype(np.int32))


def test_int_index_from_dbfolder_int16(tmp_path):
    """int16 db folders (the reference's --int16 storage) stage through
    the same path: memmap dtype from dtype.txt, L from the int16-range
    max component, results equal to the host-array build and oracle."""
    from metagenome_vector_sketches_tpu.io.dbfolder import DbFolder
    rng = np.random.default_rng(31)
    n, d = 40, 64
    V = rng.integers(-20000, 20001, size=(n, d)).astype(np.int32)
    db = DbFolder.write(str(tmp_path / "db"),
                        [f"S{i}" for i in range(n)], V, d, use_int16=True)
    Q = rng.integers(-20000, 20001, size=(3, d)).astype(np.int32)
    a = IntExactIndex(V, chunk_rows=16)
    b = IntExactIndex.from_dbfolder(db.path, chunk_rows=16)
    assert b.L == a.L and b.L >= 3                     # int16 range -> L=3
    Da, Ia = a.search(Q, 7)
    Db, Ib = b.search(Q, 7)
    assert np.array_equal(Ia, Ib) and np.array_equal(Da, Db)
    oD, oI = _oracle_topk(V, Q, 7)
    assert np.array_equal(Ia, oI.astype(np.int32))


def test_int_index_from_device_chunks_matches_host():
    """Device-chunk construction (planes decomposed on device, exact norms
    recovered from plane self-sums) must equal the host-array index,
    including a non-full last chunk; the chunk list is consumed."""
    import jax.numpy as jnp
    rng = np.random.default_rng(13)
    n, d, R = 70, 64, 32
    V = rng.integers(-900, 901, size=(n, d)).astype(np.int32)
    V[5] = 0
    Q = rng.integers(-900, 901, size=(3, d)).astype(np.int32)
    host = IntExactIndex(V, chunk_rows=R)
    chunks = [(s, jnp.asarray(V[s:s + R])) for s in range(0, n, R)]
    dev = IntExactIndex.from_device_chunks(chunks, d)
    assert len(chunks) == 0                            # consumed
    assert dev.ntotal == n and dev.L == host.L
    assert np.array_equal(dev.ns, host.ns)             # exact |v|^2 match
    Dh, Ih = host.search(Q, 9)
    Dd, Id = dev.search(Q, 9)
    assert np.array_equal(Ih, Id) and np.array_equal(Dh, Dd)


@pytest.mark.parametrize("seed", range(5))
def test_int_index_fuzz(seed):
    """Randomized conformance vs the float64 oracle: shapes, magnitudes
    (incl. int16-range -> L=3), chunking, duplicates, zero rows,
    proportional rows (exact cosine ties between DISTINCT vectors), and
    both input dtypes."""
    rng = np.random.default_rng(100 + seed)
    n = int(rng.integers(5, 200))
    d = int(rng.choice([32, 64, 128]))
    mag = int(np.exp(rng.uniform(np.log(5), np.log(30000))))
    chunk = int(rng.choice([8, 16, 64]))
    k = int(rng.choice([1, 5, 17]))
    dt = np.int16 if mag < 30000 and rng.integers(0, 2) else np.int32
    V = rng.integers(-mag, mag + 1, size=(n, d)).astype(dt)
    V[0] = 0
    if n >= 6:
        V[3] = V[2]                                     # duplicate
        V[5] = np.clip(V[4].astype(np.int64) * 2, -mag,
                       mag).astype(dt)                  # near-proportional
    nq = int(rng.integers(1, 6))
    Q = rng.integers(-mag, mag + 1, size=(nq, d)).astype(dt)
    Q[0] = V[min(2, n - 1)]
    idx = IntExactIndex(V, chunk_rows=chunk)
    D, I = idx.search(Q, k)
    oD, oI = _oracle_topk(V.astype(np.int32), Q.astype(np.int32), k)
    kk = min(k, n)
    # the returned D is the float32 cast of the exact float64 score, and
    # the engine's f64 arithmetic matches the oracle op-for-op — so the
    # cast must match BIT-exactly
    assert np.array_equal(D[:, :kk], oD[:, :kk].astype(np.float32))
    for b in range(nq):
        if not np.array_equal(I[b, :kk], oI[b, :kk]):
            # any mismatch must be an exact-tie permutation
            assert np.array_equal(np.sort(oD[b, :kk]).astype(np.float32),
                                  np.sort(D[b, :kk]))


def test_partial_selector_matches_topk():
    """selector='partial' (approx_max_k at recall_target=1.0 — exact
    per-partition selection) must return identical results to the
    lax.top_k selector. bench.py re-checks this equality on the GPU
    before trusting the other lowering."""
    rng = np.random.default_rng(23)
    V = rng.integers(-500, 501, size=(130, 64)).astype(np.int32)
    Q = rng.integers(-500, 501, size=(4, 64)).astype(np.int32)
    a = IntExactIndex(V, chunk_rows=32)
    b = IntExactIndex(V, chunk_rows=32)
    b.selector = "partial"
    Da, Ia = a.search(Q, 11)
    Db, Ib = b.search(Q, 11)
    assert np.array_equal(Ia, Ib) and np.array_equal(Da, Db)


def test_distributed_int_index_matches_single():
    """Mesh-sharded pooling (chunk axis over 8 devices, all-gather merge)
    must return IDENTICAL results to the single-device engine — the host
    finalize is exact, so any divergence is a sharding bug. Chunk count
    deliberately not a multiple of the mesh (pad chunks masked)."""
    import jax
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    from metagenome_vector_sketches_tpu.ann.distributed import (
        DistributedIntExactIndex)
    from metagenome_vector_sketches_tpu.parallel.mesh import make_mesh
    rng = np.random.default_rng(17)
    n, d, R = 150, 64, 16                              # C=10 chunks -> pad to 16
    V = rng.integers(-700, 701, size=(n, d)).astype(np.int32)
    Q = rng.integers(-700, 701, size=(5, d)).astype(np.int32)
    base = IntExactIndex(V, chunk_rows=R)
    dist = DistributedIntExactIndex.from_index(base, mesh=make_mesh(8))
    Ds, Is = base.search(Q, 12)
    Dd, Id = dist.search(Q, 12)
    assert np.array_equal(Is, Id)
    assert np.array_equal(Ds, Dd)
    oD, oI = _oracle_topk(V, Q, 12)
    assert np.array_equal(Id, oI.astype(np.int32))


def test_distributed_int_index_small_shards_fill_pool():
    """Per-device local pools smaller than the requested pool must still
    merge to the full candidate set (re-top-k at the merged width)."""
    import jax
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    from metagenome_vector_sketches_tpu.ann.distributed import (
        DistributedIntExactIndex)
    from metagenome_vector_sketches_tpu.parallel.mesh import make_mesh
    rng = np.random.default_rng(19)
    n, d, R = 64, 32, 8                                # 8 rows/device
    V = rng.integers(-200, 201, size=(n, d)).astype(np.int32)
    Q = rng.integers(-200, 201, size=(2, d)).astype(np.int32)
    base = IntExactIndex(V, chunk_rows=R)
    dist = DistributedIntExactIndex.from_index(base, mesh=make_mesh(8))
    Dd, Id = dist.search(Q, 20)                        # k > local 8-row cap
    oD, oI = _oracle_topk(V, Q, 20)
    assert np.array_equal(Id, oI.astype(np.int32))


def test_int_index_from_process_shards_single_process():
    """from_process_shards degenerates to the single-process build (one
    process owning the whole row space) and must match the from_index
    path exactly — including a row count that is not a chunk multiple."""
    import jax
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    from metagenome_vector_sketches_tpu.ann.distributed import (
        DistributedIntExactIndex)
    from metagenome_vector_sketches_tpu.parallel.mesh import make_mesh
    rng = np.random.default_rng(23)
    n, d, R = 109, 48, 16
    V = rng.integers(-600, 601, size=(n, d)).astype(np.int32)
    Q = rng.integers(-600, 601, size=(4, d)).astype(np.int32)
    mesh = make_mesh(8)
    ref = DistributedIntExactIndex.from_index(
        IntExactIndex(V, chunk_rows=R), mesh=mesh)
    got = DistributedIntExactIndex.from_process_shards(
        V, d, mesh=mesh, chunk_rows=R)
    assert got.ntotal == n and got.L == ref.L
    np.testing.assert_array_equal(got.ns, ref.ns)
    Dr, Ir = ref.search(Q, 13)
    Dg, Ig = got.search(Q, 13)
    assert np.array_equal(Ir, Ig)
    assert np.array_equal(Dr, Dg)


def test_distributed_int_index_approx_mode():
    """approx pooling (approx_max_k inside the shard_map) on the mesh:
    must run, return well-formed results, and — on a CPU mesh, where
    approx_max_k lowers to an exact top-k — match the exact engine."""
    import jax
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    from metagenome_vector_sketches_tpu.ann.distributed import (
        DistributedIntExactIndex)
    from metagenome_vector_sketches_tpu.parallel.mesh import make_mesh
    rng = np.random.default_rng(29)
    n, d, R = 140, 64, 16
    V = rng.integers(-400, 401, size=(n, d)).astype(np.int32)
    Q = rng.integers(-400, 401, size=(3, d)).astype(np.int32)
    mesh = make_mesh(8)
    base = IntExactIndex(V, chunk_rows=R, mode="approx", recall_target=0.9)
    dist = DistributedIntExactIndex.from_index(base, mesh=mesh)
    assert dist.mode == "approx"
    Dd, Id = dist.search(Q, 10)
    assert Dd.shape == (3, 10) and np.all(Id >= 0)
    oD, oI = _oracle_topk(V, Q, 10)
    assert np.array_equal(Id, oI.astype(np.int32))


def test_int_index_approx_mode_smoke():
    rng = np.random.default_rng(5)
    V = rng.integers(-300, 301, size=(96, 64)).astype(np.int32)
    Q = rng.integers(-300, 301, size=(3, 64)).astype(np.int32)
    exact = IntExactIndex(V, chunk_rows=32)
    approx = IntExactIndex(V, chunk_rows=32, mode="approx",
                           recall_target=0.95)
    De, Ie = exact.search(Q, 5)
    Da, Ia = approx.search(Q, 5)
    # pooled hits are exact-math rescored: any shared index carries the
    # identical score
    for b in range(3):
        common = set(Ie[b].tolist()) & set(Ia[b].tolist())
        for c in common:
            assert De[b][Ie[b] == c] == Da[b][Ia[b] == c]


def test_distributed_int_index_from_dbfolder_matches_single(tmp_path):
    """The direct-to-sharded db-folder constructor (each chunk staged onto
    its owning device; no transient whole-stack on one chip) must be
    result-identical to the single-device from_dbfolder path — including a
    chunk count that is not a mesh multiple, an odd tail chunk, and the
    exact int64 norms recomputed from the data."""
    import jax
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    from metagenome_vector_sketches_tpu.ann.distributed import (
        DistributedIntExactIndex)
    from metagenome_vector_sketches_tpu.io.dbfolder import DbFolder
    from metagenome_vector_sketches_tpu.parallel.mesh import make_mesh
    rng = np.random.default_rng(23)
    n, d, R = 141, 64, 16                          # C=9 chunks -> pad to 16
    V = rng.integers(-900, 901, size=(n, d)).astype(np.int32)
    db = DbFolder.write(str(tmp_path / "db"),
                        [f"S{i:04d}" for i in range(n)], V, d)
    Q = rng.integers(-900, 901, size=(6, d)).astype(np.int32)
    base = IntExactIndex.from_dbfolder(db.path, chunk_rows=R)
    dist = DistributedIntExactIndex.from_dbfolder(db.path, chunk_rows=R,
                                                  mesh=make_mesh(8))
    assert dist.L == base.L and dist.max_abs == base.max_abs
    np.testing.assert_array_equal(dist.ns, base.ns)
    Ds, Is = base.search(Q, 10)
    Dd, Id = dist.search(Q, 10)
    assert np.array_equal(Is, Id)
    assert np.array_equal(Ds, Dd)
    oD, oI = _oracle_topk(V, Q, 10)
    assert np.array_equal(Id, oI.astype(np.int32))


def test_int_index_host_build_chunked_norms():
    """_build_from_host computes norms chunk-wise (no 2x whole-array int64
    temporaries) and they stay exact int64."""
    rng = np.random.default_rng(29)
    n, d = 70, 48
    V = rng.integers(-1200, 1201, size=(n, d)).astype(np.int32)
    idx = IntExactIndex(V, chunk_rows=16)
    expect = np.einsum("ij,ij->i", V.astype(np.int64), V.astype(np.int64))
    np.testing.assert_array_equal(idx.ns, expect)
    assert idx.ns.dtype == np.int64


def test_combine_partials_f32_within_float32_bound():
    """The plane combine on partials above 2^11 agrees with the numpy
    float32 weighted sum within float32 rounding (test_chip repeats this on
    the card, where a TF32 contraction would fail it)."""
    from helpers import combine_f32_bound_holds
    assert combine_f32_bound_holds(seed=1)
