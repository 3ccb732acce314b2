"""Conformance gates for the pairwise engine (SURVEY.md §7.3 step 3):
decoded (row, col, quantized-jaccard) triple sets must match the exact
reference-semantics oracle on the toy db, for both dtypes and any sharding.
"""

import numpy as np
import pytest

from metagenome_vector_sketches_tpu.io.dbfolder import DbFolder
from metagenome_vector_sketches_tpu.matrix.compute import (
    compute_pairwise_shard, compute_pairwise_oracle,
)
from metagenome_vector_sketches_tpu.matrix.reader import MatrixReader
from metagenome_vector_sketches_tpu.matrix.writer import quantize_jaccard
from metagenome_vector_sketches_tpu.ops import pairwise as pw


def _oracle_triples(db: DbFolder):
    _, norms = db.names_and_norms()
    norms_sq = norms * norms
    vecs = db.load_vectors().astype(np.int32)
    r, c, v = compute_pairwise_oracle(vecs, norms_sq, db.dimension, db.dtype)
    q = quantize_jaccard(v, r, c, norms_sq, db.dimension)
    return set(zip(r.tolist(), c.tolist(), q.tolist()))


def _decoded_triples(matrix_folder: str, total: int):
    reader = MatrixReader(matrix_folder)
    r, c, q = reader.decode_all_triples(total)
    return set(zip(r.tolist(), c.tolist(), q.tolist()))


@pytest.mark.parametrize("db_name,num_shards,budget", [
    ("toy_db_256", 1, 8 << 30),
    ("toy_db_256", 3, 8 << 30),
    ("toy_db_256", 2, 0),        # force the streaming fallback path
    ("toy_db_2048", 1, 8 << 30),
    ("toy_db_2048_i16", 1, 8 << 30),
    ("toy_db_2048_i16", 1, 0),   # int16 dtype through the streaming path
])
def test_pairwise_matches_oracle(tmp_path, ref_toy_dir, db_name, num_shards,
                                 budget):
    db = DbFolder(str(ref_toy_dir / db_name))
    out = str(tmp_path / "matrix")
    for s in range(num_shards):
        compute_pairwise_shard(str(ref_toy_dir / db_name), out,
                               num_shards=num_shards, shard_idx=s,
                               tile_rows=32, tile_cols=32, verbose=False,
                               device_budget_bytes=budget)
    got = _decoded_triples(out, db.num_vectors)
    want = _oracle_triples(db)
    assert got == want
    # sanity: self-pairs present with q ~ 255 (reference keeps them, :659)
    selfs = [q for (r, c, q) in got if r == c]
    assert selfs and min(selfs) >= 254


def test_streaming_prefetch_crosses_row_groups(tmp_path, ref_toy_dir):
    """budget=0 with a small tile forces multiple row groups x multiple
    column windows — exercises the streaming engine's one-deep window
    prefetch across the row-group boundary (the flattened schedule)."""
    db = DbFolder(str(ref_toy_dir / "toy_db_256"))
    out = str(tmp_path / "matrix")
    compute_pairwise_shard(str(ref_toy_dir / "toy_db_256"), out,
                           num_shards=1, shard_idx=0, tile_rows=16,
                           verbose=False, device_budget_bytes=0)
    assert _decoded_triples(out, db.num_vectors) == _oracle_triples(db)


def test_limb_decomposition_exact():
    rng = np.random.default_rng(11)
    import jax.numpy as jnp
    for max_abs in [1, 127, 128, 3000, 32767, 2**20]:
        L = pw.pick_limbs(max_abs)
        v = rng.integers(-max_abs, max_abs + 1, size=(8, 64)).astype(np.int32)
        limbs = np.asarray(pw.decompose_limbs(jnp.asarray(v), L)).astype(np.int64)
        recon = sum(limbs[k] * (1 << (7 * k)) for k in range(L - 1))
        recon = recon + limbs[L - 1] * (1 << (7 * (L - 1)))
        np.testing.assert_array_equal(recon, v.astype(np.int64))
        if L > 1:
            # balanced digits: every limb in [-64, 63] so limb SUMS fit int8
            # (the property the Karatsuba combine in approx_dot_f32 relies on)
            assert limbs.min() >= -64 and limbs.max() <= 63


def test_approx_dot_karatsuba_exact():
    """approx_dot_f32 over Karatsuba planes (L(L+1)/2 matmuls) must equal
    the exact integer dot up to the float32 rounding the threshold slack is
    sized for."""
    rng = np.random.default_rng(13)
    import jax.numpy as jnp
    d = 256
    for max_abs in [100, 1500, 32767]:
        L = pw.pick_limbs(max_abs)
        vi = rng.integers(-max_abs, max_abs + 1, size=(16, d)).astype(np.int32)
        vj = rng.integers(-max_abs, max_abs + 1, size=(24, d)).astype(np.int32)
        pi = pw.decompose_planes(jnp.asarray(vi), L)
        pj = pw.decompose_planes(jnp.asarray(vj), L)
        assert pi.shape[0] == pw.num_planes(L)
        got = np.asarray(pw.approx_dot_f32(pi, pj)).astype(np.float64)
        want = (vi.astype(np.int64) @ vj.astype(np.int64).T).astype(np.float64)
        # float32 relative rounding of the weighted combine only
        np.testing.assert_allclose(got, want, rtol=1e-6,
                                   atol=max(1.0, np.abs(want).max() * 1e-6))


def test_more_shards_than_rows(tmp_path):
    """num_shards > N: shards with empty row ranges write empty-but-valid
    folders that the reader and query stack handle (small tile so the empty
    row range maps to zero row tiles — the regression case)."""
    from metagenome_vector_sketches_tpu.query.engine import query
    rng = np.random.default_rng(3)
    V = rng.integers(-100, 100, size=(3, 64)).astype(np.int32)
    DbFolder.write(str(tmp_path / "db"), ["A0", "A1", "A2"], V, 64)
    for s in range(5):
        compute_pairwise_shard(str(tmp_path / "db"), str(tmp_path / "mat"),
                               num_shards=5, shard_idx=s, tile_rows=4,
                               tile_cols=4, verbose=False)
    got = _decoded_triples(str(tmp_path / "mat"), 3)
    assert got == _oracle_triples(DbFolder(str(tmp_path / "db")))
    res = query(str(tmp_path / "mat"), [0, 1, 2], np.ones(3), ["A0", "A1", "A2"])
    assert [x.self_id for x in res] == ["A0", "A1", "A2"]


@pytest.mark.parametrize("n", [1, 2])
def test_tiny_db_self_pairs(tmp_path, n):
    """Degenerate databases: every row keeps its self pair at q=255."""
    rng = np.random.default_rng(n)
    V = rng.integers(-100, 100, size=(n, 64)).astype(np.int32)
    DbFolder.write(str(tmp_path / "db"), [f"A{i}" for i in range(n)], V, 64)
    compute_pairwise_shard(str(tmp_path / "db"), str(tmp_path / "mat"),
                           verbose=False)
    got = _decoded_triples(str(tmp_path / "mat"), n)
    db = DbFolder(str(tmp_path / "db"))
    assert got == _oracle_triples(db)
    assert all(q == 255 for (r, c, q) in got if r == c)


def test_extraction_chunking_matches_oracle(tmp_path, ref_toy_dir, monkeypatch):
    """Force tiny extraction batches so the K-chunk loop runs many times;
    decoded triples must still equal the oracle exactly."""
    from metagenome_vector_sketches_tpu.matrix import compute as mc
    monkeypatch.setattr(mc, "_max_tiles_per_batch", lambda tile: 2)
    db = DbFolder(str(ref_toy_dir / "toy_db_256"))
    out = str(tmp_path / "matrix")
    compute_pairwise_shard(str(ref_toy_dir / "toy_db_256"), out,
                           tile_rows=16, tile_cols=16, verbose=False)
    got = _decoded_triples(out, db.num_vectors)
    assert got == _oracle_triples(db)


def test_max_tiles_per_batch_respects_int32():
    """Packed candidate indices must stay within int32 for every extraction
    batch the engine can build (regression: tile=2048 with many hot tiles)."""
    from metagenome_vector_sketches_tpu.matrix.compute import _max_tiles_per_batch
    for tile in [256, 512, 1024, 2048, 4096, 8192]:
        k = _max_tiles_per_batch(tile)
        assert k >= 1
        assert k * tile * tile <= 2**31 - 1


@pytest.mark.parametrize("case", ["full_grid", "row_range", "int16_P6"])
def test_sweep_counts_within_oracle_bounds(case):
    """The XLA counts sweep (the two-phase engine's phase 1) against exact
    float64 counts: each tile's count lies between the pairs that pass the
    sweep threshold by more than the certified float32 error and those that
    come within it (required_slack_abs bounds the combine's error)."""
    import jax.numpy as jnp
    rng = np.random.default_rng({"full_grid": 0, "row_range": 1,
                                 "int16_P6": 2}[case])
    n, d, tile = 512, 128, 128
    max_abs = 30000 if case == "int16_P6" else 1500
    protos = rng.integers(-max_abs // 2, max_abs // 2 + 1, size=(64, d))
    V = (protos[rng.integers(0, 64, n)]
         + rng.integers(-max_abs // 2, max_abs // 2 + 1, size=(n, d)))
    V = np.clip(V, -max_abs, max_abs).astype(np.int32)
    L = pw.pick_limbs(max_abs)
    assert pw.num_planes(L) == (6 if case == "int16_P6" else 3)
    thr = (np.einsum("ij,ij->i", V.astype(np.float64), V.astype(np.float64))
           / d).astype(np.float32)
    nt = n // tile
    rows = range(1, 3) if case == "row_range" else range(nt)
    coords = np.array([(r, c) for r in rows for c in range(nt)], np.int32)
    got = np.asarray(pw.sweep_counts(pw.decompose_planes(jnp.asarray(V), L),
                                     jnp.asarray(thr), jnp.asarray(coords),
                                     tile))
    slack = pw.required_slack_abs(L, max_abs, d)
    Vi = V.astype(np.int64)
    t64 = thr.astype(np.float64)
    for (r, c), g in zip(coords, got):
        a = slice(r * tile, (r + 1) * tile)
        b = slice(c * tile, (c + 1) * tile)
        lhs = (Vi[a] @ Vi[b].T) / d
        rhs = (0.05 * (t64[a, None] + t64[None, b]) * float(pw.SLACK_REL)
               - float(pw.SLACK_ABS))
        margin = slack + 1e-6 * np.abs(rhs) + 1e-3
        assert int((lhs > rhs + margin).sum()) <= g \
            <= int((lhs > rhs - margin).sum()), (r, c)
    assert got.sum() > 0 and (got < tile * tile).any()
