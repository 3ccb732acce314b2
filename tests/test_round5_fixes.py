"""Round-5 fixes (VERDICT r4): targeted tests for the round-4 rewrites that
landed without tests, plus the ADVICE r4 finalizer bookkeeping fixes.

- gate=True (HLO-conditional skip of selection+partials on candidate-free
  tiles, ops/pairwise.py sweep_extract_fused_ij) — kernel equality on a
  mixed hot/cold grid, engine oracle-equality single-device AND under the
  8-device mesh (the axis-varying cond constant fix is exactly the kind of
  thing that silently breaks under shard_map).
- frontier-batched adaptive search (ann/search.py): queries pinned at
  DIFFERENT expansion levels inside one round must equal a serial
  per-query loop implementing the reference semantics (jaccard.py:127-170).
- two-stage exact selector (ann/int_index.py _int_scan_pool): adversarial
  tie grids (duplicated scores straddling 128-block boundaries, kc edge
  cases) vs an independent numpy oracle with lax.top_k tie order.
- finalizer bookkeeping: LAST_STAGES['candidates'] means
  device-extracted volume (mirror twins only under 'emitted'), and the
  dense/retry mirror path computes each unordered pair's exact dot ONCE.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from metagenome_vector_sketches_tpu.io.dbfolder import DbFolder
from metagenome_vector_sketches_tpu.ops import pairwise as pw
from metagenome_vector_sketches_tpu.matrix import compute as mc
from helpers import assert_matrix_matches_oracle


# ---------------------------------------------------------------- gate=True

def _two_orthogonal_clusters(n, d, seed):
    """Rows 0..n/2 live in dims [0, d/2), the rest in [d/2, d): cross-cluster
    dots are EXACTLY zero while norms are large, so every cross tile fails
    the 0.05*(ni+nj) sweep threshold -> genuinely COLD tiles."""
    rng = np.random.default_rng(seed)
    V = np.zeros((n, d), dtype=np.int32)
    V[:n // 2, :d // 2] = rng.integers(40, 61, size=(n // 2, d // 2))
    V[n // 2:, d // 2:] = rng.integers(40, 61, size=(n - n // 2, d - d // 2))
    return V


def test_gate_kernel_equals_ungated_on_mixed_grid():
    """gate=True must produce bit-identical (cand, partials, counts) to the
    ungated kernel on a grid mixing hot tiles (within-cluster) and cold
    tiles (cross-cluster, zero survivors — the branch the cond skips)."""
    n, d, tile = 128, 32, 32
    V = _two_orthogonal_clusters(n, d, 50)
    norms_sq = (np.einsum("ij,ij->i", V.astype(np.float64),
                          V.astype(np.float64)) / d)
    L = pw.pick_limbs(60)
    planes = pw.decompose_planes(jnp.asarray(V), L)
    thr = jnp.asarray(norms_sq.astype(np.float32))
    nt = n // tile
    coords = jnp.asarray(np.array([(r, c, 1) for r in range(nt)
                                   for c in range(nt)], dtype=np.int32))
    cap = tile * tile
    c0, p0, n0 = pw.sweep_extract_fused(planes, thr, coords, tile, L, cap)
    c1, p1, n1 = pw.sweep_extract_fused(planes, thr, coords, tile, L, cap,
                                        gate=True)
    np.testing.assert_array_equal(np.asarray(n0), np.asarray(n1))
    np.testing.assert_array_equal(np.asarray(c0), np.asarray(c1))
    np.testing.assert_array_equal(np.asarray(p0), np.asarray(p1))
    # the grid genuinely mixes hot and cold tiles (or the test proves nothing)
    counts = np.asarray(n0)
    assert (counts == 0).any() and (counts > 0).any()


def test_fused_engine_gate_oracle(tmp_path):
    """compute_pairwise_shard(gate=True) end-to-end oracle equality —
    the CLI-reachable plumbing of the gated kernel."""
    n, d = 96, 64
    V = _two_orthogonal_clusters(n, d, 51)
    db = DbFolder.write(str(tmp_path / "db"), [f"S{i}" for i in range(n)],
                        V, d)
    mc.compute_pairwise_shard(db.path, str(tmp_path / "m"), tile_rows=16,
                              verbose=False, gate=True)
    assert mc.LAST_STAGES.get("mode") == "fused"
    _, norms = db.names_and_norms()
    assert_matrix_matches_oracle(V, norms * norms, d, str(tmp_path / "m"), n)


def test_fused_engine_gate_mesh_oracle(tmp_path):
    """gate=True under the 8-device mesh: the cond's branch outputs must
    keep matching axis-varying types under shard_map (ops/pairwise.py's
    `+ cand_count*0` fix) — this is the configuration that would silently
    break."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    from metagenome_vector_sketches_tpu.parallel.mesh import make_mesh
    n, d = 128, 64
    V = _two_orthogonal_clusters(n, d, 52)
    db = DbFolder.write(str(tmp_path / "db"), [f"S{i}" for i in range(n)],
                        V, d)
    mc.compute_pairwise_shard(db.path, str(tmp_path / "m"), tile_rows=16,
                              verbose=False, mesh=make_mesh(8), gate=True)
    _, norms = db.names_and_norms()
    assert_matrix_matches_oracle(V, norms * norms, d, str(tmp_path / "m"), n)


def test_gate_cli_flag(tmp_path):
    """--gate_sparse_tiles reaches the engine through the CLI surface."""
    from metagenome_vector_sketches_tpu.cli import pairwise_comp
    n, d = 64, 32
    V = _two_orthogonal_clusters(n, d, 53)
    db = DbFolder.write(str(tmp_path / "db"), [f"S{i}" for i in range(n)],
                        V, d)
    rc = pairwise_comp.main([
        "--db", db.path, "--max_memory_gb", "1", "--num_threads", "1",
        "--output_folder", str(tmp_path / "m"), "--num_shards", "1",
        "--shard_idx", "0", "--tile", "16", "--mesh_devices", "1",
        "--gate_sparse_tiles"])
    assert rc == 0
    _, norms = db.names_and_norms()
    assert_matrix_matches_oracle(V, norms * norms, d,
                                 str(tmp_path / "m"), n)


# ----------------------------------------- frontier-batched adaptive search

def _serial_reference_search(index, queries_f64, j, db_norms,
                             queries_int=None):
    """The reference's PER-QUERY expansion loop (jaccard.py:120-174),
    executed serially — the semantics the frontier-batched adaptive_search
    must reproduce exactly. Collects every valid candidate at the final
    level (the exact filter happens in rescore, same as the batched path)."""
    from metagenome_vector_sketches_tpu.ann.search import (
        INITIAL_NB_SEARCHES, MAX_LEVELS)
    from metagenome_vector_sketches_tpu.ann.flat_index import normalize_l2
    queries = queries_f64.astype(np.float32)
    query_norms = np.linalg.norm(queries, axis=1)
    qn = normalize_l2(queries)
    min_ip = np.float32(2 * j / (1 + j))
    hits = []
    for qi in range(len(qn)):
        level = 0
        while True:
            nbs = INITIAL_NB_SEARCHES * 3 ** level
            nb_eff = min(nbs, index.ntotal)
            if queries_int is not None:
                D, I = index.search(queries_int[qi:qi + 1], nb_eff)
            else:
                D, I = index.search(qn[qi:qi + 1], nb_eff)
            D, I = D[0], I[0]
            any_above = bool(np.any(D[:nb_eff] > min_ip))
            kth = np.float32(D[nb_eff - 1])
            deeper = any_above and kth > min_ip and nbs < index.ntotal
            if deeper:
                if kth - np.float32(0.05) > min_ip and level <= MAX_LEVELS - 3:
                    level += 2
                    continue
                elif level <= MAX_LEVELS - 2:
                    level += 1
                    continue
            break
        for rank in range(nb_eff):
            if I[rank] >= 0:
                hits.append((qi, int(I[rank]), float(D[rank])))
    return hits, query_norms


def _rescored_map(hits, qn, names, norms, j):
    from metagenome_vector_sketches_tpu.ann.search import rescore
    out = rescore(hits, qn, names, norms, j, verbose=False)
    return {(q, nid): jac for q, nid, jac in out}


def _assert_rescored_equal(got, want):
    """Same neighbor MEMBERSHIP per query; jaccard values equal up to the
    f32 inner-product ulp drift between different batch shapes (XLA picks
    a different accumulation order per program shape — the batched round
    scans at the round's max nb, the serial loop per-query)."""
    assert got.keys() == want.keys(), (
        sorted(got.keys() - want.keys())[:5],
        sorted(want.keys() - got.keys())[:5])
    for key, jac in got.items():
        np.testing.assert_allclose(jac, want[key], rtol=1e-5, atol=1e-6,
                                   err_msg=str(key))


def _mixed_level_db(seed=60):
    """Float db engineered so one batch of queries lands at DIFFERENT
    expansion levels within one frontier round:
      q0 -> few neighbors, stops at level 0;
      q1 -> ~100 rows at ip ~= 0.48 (inside the 0.05 estimate window above
            min_ip = 0.4615 at j=0.3), takes the +1 branch to level 1;
      q2 -> 500 near-identical rows, takes the +2 branch to level 2.
    Round 2 then batches q1 at nb=150 with q2 at nb=450 — the shared-scan
    per-query slicing under test."""
    rng = np.random.default_rng(seed)
    d = 64
    b1 = rng.normal(size=d)
    b1 /= np.linalg.norm(b1)
    o1 = rng.normal(size=d)
    o1 -= (o1 @ b1) * b1
    o1 /= np.linalg.norm(o1)
    b2 = rng.normal(size=d)
    b2 /= np.linalg.norm(b2)
    ip = 0.48
    ring = (ip * b1[None, :] + np.sqrt(1 - ip * ip) * o1[None, :]
            + 0.001 * rng.normal(size=(100, d)))
    close = b2[None, :] + 0.01 * rng.normal(size=(500, d))
    far = rng.normal(size=(1000, d))
    V = np.concatenate([ring, close, far]).astype(np.float32)
    queries = np.stack([rng.normal(size=d), b1, b2]).astype(np.float64)
    return V, queries


def test_frontier_mixed_levels_matches_serial_reference():
    from metagenome_vector_sketches_tpu.ann.search import adaptive_search
    from metagenome_vector_sketches_tpu.ann.flat_index import (
        FlatIPIndex, normalize_l2)
    V, queries = _mixed_level_db()
    norms = np.linalg.norm(V, axis=1).astype(np.float64)
    idx = FlatIPIndex(normalize_l2(V), chunk_rows=1024)
    j = 0.3
    names = [f"A{i}" for i in range(len(V))]
    hits_b, qn_b = adaptive_search(idx, queries, j, verbose=False,
                                   db_norms=norms)
    hits_s, qn_s = _serial_reference_search(idx, queries, j, norms)
    np.testing.assert_allclose(qn_b, qn_s, rtol=1e-6)
    _assert_rescored_equal(_rescored_map(hits_b, qn_b, names, norms, j),
                           _rescored_map(hits_s, qn_s, names, norms, j))
    # the scenario actually exercised a mixed-level round: the serial
    # reference must have visited three distinct final levels (distinct
    # raw candidate counts = distinct final nb)
    finals = set()
    for qi in range(3):
        h = [i for q, i, _ in hits_s if q == qi]
        finals.add(len(h))
    assert len(finals) == 3


def test_frontier_mixed_levels_int8_engine():
    """Same mixed-level scenario through the int8-plane exact engine
    (queries_int path): the frontier rounds route index.search at the
    round's max nb and slice per-query — must equal the serial loop over
    the SAME engine."""
    from metagenome_vector_sketches_tpu.ann.search import adaptive_search
    from metagenome_vector_sketches_tpu.ann.int_index import IntExactIndex
    V, queries = _mixed_level_db(seed=61)
    Vi = np.round(V * 1000).astype(np.int32)
    q_int = np.round(queries * 1000).astype(np.int32)
    d = Vi.shape[1]
    queries_f64 = q_int.astype(np.float64) / np.sqrt(d)
    norms = np.sqrt(np.einsum("ij,ij->i", Vi.astype(np.float64),
                              Vi.astype(np.float64)))
    idx = IntExactIndex(Vi, chunk_rows=1024)
    j = 0.3
    names = [f"A{i}" for i in range(len(Vi))]
    hits_b, qn_b = adaptive_search(idx, queries_f64, j, verbose=False,
                                   db_norms=norms, queries_int=q_int)
    hits_s, qn_s = _serial_reference_search(idx, queries_f64, j, norms,
                                            queries_int=q_int)
    np.testing.assert_allclose(qn_b, qn_s, rtol=1e-6)
    _assert_rescored_equal(_rescored_map(hits_b, qn_b, names, norms, j),
                           _rescored_map(hits_s, qn_s, names, norms, j))


# ------------------------------------------------- two-stage exact selector

def _tie_grid_vectors(R, d, seed):
    """Integer vectors built from FEW prototypes so scores form large
    exact-tie classes scattered across 128-blocks; prototypes are small
    enough for L=1 (single plane, so the f32 device score is exactly
    reproducible in numpy)."""
    rng = np.random.default_rng(seed)
    protos = rng.integers(-4, 5, size=(8, d)).astype(np.int32)
    assign = rng.integers(0, 8, size=R)
    V = protos[assign]
    # hand-placed duplicates straddling 128-block boundaries
    V[120:136] = protos[0]
    V[255:258] = protos[1]
    V[1023:1026] = protos[2]
    return V


@pytest.mark.parametrize("pool", [1, 7, 16])
def test_two_stage_selector_tie_oracle(pool):
    """_int_scan_pool's two-stage per-chunk selector vs an independent
    numpy oracle with lax.top_k's tie order (descending score, lowest
    index first): duplicated scores straddle 128-block boundaries and the
    kc-th cut falls INSIDE a tie class; kc edges (1, odd, kc == nb)."""
    from metagenome_vector_sketches_tpu.ann.int_index import (
        IntExactIndex, _int_scan_pool, _host_planes)
    R, d = 2048, 16
    V = _tie_grid_vectors(R, d, 70)
    idx = IntExactIndex(V, chunk_rows=R)
    assert idx.L == 1  # single plane -> numpy-exact f32 score oracle
    nb = R // 128
    kc = min(pool, R)
    assert kc <= nb and kc < R and R % 128 == 0  # two-stage conditions hold
    Q = np.concatenate([V[[120, 255, 1023, 0]],
                        np.random.default_rng(71).integers(
                            -4, 5, size=(4, d))]).astype(np.int32)
    qp = jnp.asarray(_host_planes(Q, idx.L))
    s, i, p = _int_scan_pool(qp, idx._stack, idx._inv_n, R, pool)
    s, i, p = np.asarray(s), np.asarray(i), np.asarray(p)

    # numpy oracle of the device math: exact int32 plane dot, f32 combine
    # (weight 1.0 at L=1), f32 * f32 inv-norm — every step exact in f32
    S = (Q.astype(np.int64) @ V.astype(np.int64).T).astype(np.int32)
    ns = np.einsum("ij,ij->i", V.astype(np.int64), V.astype(np.int64))
    inv = (1.0 / np.sqrt(ns.astype(np.float64))).astype(np.float32)
    score = S.astype(np.float32) * inv[None, :]
    for b in range(len(Q)):
        order = np.lexsort((np.arange(R), -score[b]))[:kc]
        np.testing.assert_array_equal(i[b][:kc], order,
                                      err_msg=f"query {b}")
        np.testing.assert_array_equal(s[b][:kc], score[b][order])
        np.testing.assert_array_equal(p[0, b][:kc], S[b][order])
        # the cut genuinely falls inside a tie class for the self-queries
        if b < 3 and kc > 1:
            assert score[b][order[-1]] == score[b][order[-2]] or \
                (score[b] == score[b][order[-1]]).sum() >= 1


def test_two_stage_selector_matches_plain_topk_large_pool():
    """Cross-check at a pool just past nb (two-stage disabled -> plain
    lax.top_k): the first nb entries must equal the two-stage run at
    pool=nb — the exact-prefix property the two-stage argument claims."""
    from metagenome_vector_sketches_tpu.ann.int_index import (
        IntExactIndex, _int_scan_pool, _host_planes)
    R, d = 1024, 16
    V = _tie_grid_vectors(R, d, 72)
    idx = IntExactIndex(V, chunk_rows=R)
    nb = R // 128
    Q = V[[120, 0, 500]].astype(np.int32)
    qp = jnp.asarray(_host_planes(Q, idx.L))
    s2, i2, p2 = _int_scan_pool(qp, idx._stack, idx._inv_n, R, nb)
    s1, i1, p1 = _int_scan_pool(qp, idx._stack, idx._inv_n, R, nb + 1)
    np.testing.assert_array_equal(np.asarray(i1)[:, :nb], np.asarray(i2))
    np.testing.assert_array_equal(np.asarray(s1)[:, :nb], np.asarray(s2))
    np.testing.assert_array_equal(np.asarray(p1)[:, :, :nb],
                                  np.asarray(p2))


# --------------------------------------------- finalizer bookkeeping (ADVICE)

def test_candidates_counts_extraction_not_mirrors(tmp_path):
    """Single-shard all-vs-all (triangle grid + host mirroring):
    LAST_STAGES['candidates'] must reflect device-extracted volume only;
    mirror twins land under 'emitted'."""
    rng = np.random.default_rng(80)
    n, d = 96, 64
    V = rng.integers(-200, 201, size=(n, d)).astype(np.int32)
    V[10:40] = V[9] + rng.integers(-1, 2, size=(30, d)).astype(np.int32)
    db = DbFolder.write(str(tmp_path / "db"), [f"S{i}" for i in range(n)],
                        V, d)
    mc.compute_pairwise_shard(db.path, str(tmp_path / "m"), tile_rows=16,
                              verbose=False)
    _, norms = db.names_and_norms()
    assert_matrix_matches_oracle(V, norms * norms, d, str(tmp_path / "m"), n)
    cand = mc.LAST_STAGES["candidates"]
    emitted = mc.LAST_STAGES["emitted"]
    # the clustered block guarantees off-diagonal-tile pairs, so mirrors
    # exist: emitted strictly exceeds extraction volume
    assert emitted > cand
    # every written pair traces back to an emission; extraction volume must
    # not be inflated by mirrors (the old behavior had candidates ~= emitted)
    assert mc.LAST_STAGES["pairs_written"] <= emitted


def test_dense_mirror_path_oracle_and_single_dot_compute(tmp_path,
                                                         monkeypatch):
    """Ultra-dense everything + tiny cap floor forces the dense-bitmap
    retry through the MIRRORED finalize_globals: exact dots are computed
    once per unordered pair and both directions emitted — results must
    stay oracle-equal and the dot computation must see each unordered pair
    exactly once."""
    monkeypatch.setattr(mc, "FUSED_CAP_FLOOR", 4)
    rng = np.random.default_rng(81)
    n, d = 64, 32
    base = rng.integers(30, 61, size=d).astype(np.int32)
    V = base[None, :] + rng.integers(-1, 2, size=(n, d)).astype(np.int32)
    db = DbFolder.write(str(tmp_path / "db"), [f"S{i}" for i in range(n)],
                        V, d)

    seen_pairs = []
    orig = pw.exact_dots_host

    def spy(Vv, rows, cols, max_abs, chunk=None):
        seen_pairs.append(np.stack([np.minimum(rows, cols),
                                    np.maximum(rows, cols)], axis=1))
        return orig(Vv, rows, cols, max_abs, chunk)

    monkeypatch.setattr(pw, "exact_dots_host", spy)
    mc.clear_device_cache()
    mc.compute_pairwise_shard(db.path, str(tmp_path / "m"), tile_rows=16,
                              verbose=False, finalize="host")
    _, norms = db.names_and_norms()
    assert_matrix_matches_oracle(V, norms * norms, d, str(tmp_path / "m"), n)
    if seen_pairs:  # dense bitmap path taken (it is, with floor=4)
        allp = np.concatenate(seen_pairs)
        offdiag = allp[allp[:, 0] != allp[:, 1]]
        uniq = np.unique(offdiag, axis=0)
        # each unordered off-diagonal pair's dot computed exactly once
        assert len(offdiag) == len(uniq)


# -------------------------------- device-resident int8 adaptive frontier

def test_device_frontier_emits_exact_f64_cosines():
    """Round-5 device-resident int route: emitted hit ips must be the
    float64-EXACT cosines recombined from the compacted int32 plane
    partials (round 4 emitted float32 casts of index.search scores) —
    checked against an independent int64 numpy oracle."""
    from metagenome_vector_sketches_tpu.ann.search import adaptive_search
    from metagenome_vector_sketches_tpu.ann.int_index import IntExactIndex
    rng = np.random.default_rng(70)
    n, d = 700, 48
    V = rng.integers(-100, 101, size=(n, d)).astype(np.int32)
    # plant a near-duplicate cluster; queries are scaled ~sqrt(d) so their
    # 1/sqrt(d) norms land NEAR the db norms (the reference's mixed-unit
    # jac filter only passes j when qn ~= nn, jaccard.py:211)
    base = rng.integers(-100, 101, size=d).astype(np.int32)
    V[10:40] = base + rng.integers(-2, 3, size=(30, d))
    V[0, 0] = 800   # widen the db limb range to cover the scaled queries
    q_int = rng.integers(-700, 701, size=(3, d)).astype(np.int32)
    q_int[1] = base * 7
    queries_f64 = q_int.astype(np.float64) / np.sqrt(d)
    norms = np.sqrt(np.einsum("ij,ij->i", V.astype(np.float64),
                              V.astype(np.float64)))
    idx = IntExactIndex(V, chunk_rows=256)
    hits, _ = adaptive_search(idx, queries_f64, j=0.2, verbose=False,
                              db_norms=norms, queries_int=q_int)
    assert hits, "scenario must produce hits"
    dots = V.astype(np.int64) @ q_int.astype(np.int64).T        # (n, 3)
    qns = np.einsum("ij,ij->i", q_int.astype(np.int64),
                    q_int.astype(np.int64))
    ns = np.einsum("ij,ij->i", V.astype(np.int64), V.astype(np.int64))
    for q, i, ip in hits:
        want = dots[i, q] / np.sqrt(ns[i].astype(np.float64)
                                    * qns[q].astype(np.float64))
        np.testing.assert_allclose(ip, want, rtol=1e-12, err_msg=(q, i))


def test_device_frontier_no_db_norms_branch():
    """db_norms=None + queries_int: the host-side keep-everything collect
    must also recombine exact ips from the device partials."""
    from metagenome_vector_sketches_tpu.ann.search import (
        adaptive_search, rescore)
    from metagenome_vector_sketches_tpu.ann.int_index import IntExactIndex
    rng = np.random.default_rng(71)
    n, d = 300, 36
    V = rng.integers(-80, 81, size=(n, d)).astype(np.int32)
    base = rng.integers(-80, 81, size=d).astype(np.int32)
    V[5:25] = base + rng.integers(-2, 3, size=(20, d))
    V[0, 0] = 520   # widen the db limb range to cover the scaled queries
    q_int = rng.integers(-480, 481, size=(2, d)).astype(np.int32)
    q_int[0] = base * 6
    queries_f64 = q_int.astype(np.float64) / np.sqrt(d)
    norms = np.sqrt(np.einsum("ij,ij->i", V.astype(np.float64),
                              V.astype(np.float64)))
    idx = IntExactIndex(V, chunk_rows=128)
    j = 0.2
    names = [f"A{i}" for i in range(n)]
    hits_n, qn_n = adaptive_search(idx, queries_f64, j, verbose=False,
                                   db_norms=None, queries_int=q_int)
    hits_d, qn_d = adaptive_search(idx, queries_f64, j, verbose=False,
                                   db_norms=norms, queries_int=q_int)
    got = {(q, nid): jac for q, nid, jac
           in rescore(hits_n, qn_n, names, norms, j, verbose=False)}
    want = {(q, nid): jac for q, nid, jac
            in rescore(hits_d, qn_d, names, norms, j, verbose=False)}
    assert got and got.keys() == want.keys()
    for key, jac in got.items():
        np.testing.assert_allclose(jac, want[key], rtol=1e-9)


def test_int_search_stage_attribution_populated():
    """IntExactIndex.search() records the per-stage wall split (VERDICT r4
    #1): every stage key present, positive, and the D2H byte count equals
    the ONE packed buffer (B*pool + P*B*pool int32s)."""
    from metagenome_vector_sketches_tpu.ann import int_index as ii
    rng = np.random.default_rng(72)
    n, d = 400, 32
    V = rng.integers(-200, 201, size=(n, d)).astype(np.int32)
    idx = ii.IntExactIndex(V, chunk_rows=128)
    Q = rng.integers(-200, 201, size=(4, d)).astype(np.int32)
    D, I = idx.search(Q, 10)
    st = ii.LAST_SEARCH_STAGES
    for key in ("prep_ms", "dispatch_ms", "device_d2h_ms", "finalize_ms"):
        assert key in st and st[key] >= 0, (key, st)
    P = pw.num_planes(idx.L)
    pool = idx.pool_for(10)
    assert st["d2h_bytes"] == 4 * (4 * pool + P * 4 * pool)


# ------------------------------------------- small-norm sweep slack (r5)

def test_small_norm_db_sweep_slack_tightened(tmp_path):
    """A db of small-norm accessions (few hashes -> ns ~ tens, as real
    small-genome FracMinHash sketches have) must NOT pass a constant
    fraction of all pairs to the exact finalize: the fixed SLACK_ABS=16
    would swamp the 0.05*(ni+nj) threshold (measured r5: 1.54e9
    candidates for 441k pairs at N=262k). threshold_adjust tightens the
    effective slack to the certified requirement; output stays
    oracle-equal."""
    rng = np.random.default_rng(81)
    n, d = 256, 1024
    # ns ~ 91: retention threshold 0.05*(ni+nj) ~ 9.1 < old effective
    # slack 16 -> EVERY pair passed the old sweep; with the tightened
    # slack (~1.0) the pass bound sits ~2.8 sigma above the background
    # dot fluctuation (sigma = ns/sqrt(d) ~ 2.8), so the sweep is
    # selective again
    V = rng.integers(-16, 17, size=(n, d)).astype(np.int32)
    V[3] = V[2]                                   # one genuine pair
    db = DbFolder.write(str(tmp_path / "db"), [f"S{i}" for i in range(n)],
                        V, d)
    mc.compute_pairwise_shard(db.path, str(tmp_path / "m"), tile_rows=64,
                              verbose=False)
    _, norms = db.names_and_norms()
    assert_matrix_matches_oracle(V, norms * norms, d, str(tmp_path / "m"), n)
    # with the tightened slack the sweep is selective again: well under
    # 10% of the n*n candidate volume (the old fixed slack passed 100%)
    assert mc.LAST_STAGES["candidates"] < 0.1 * n * n, \
        mc.LAST_STAGES["candidates"]


def test_threshold_adjust_directions():
    """threshold_adjust must equal -extra_threshold_margin when widening
    and keep >= 2x certified slack (floor 1.0) when tightening."""
    for L, max_abs in ((1, 5), (2, 1200), (3, 32767)):
        need = pw.required_slack_abs(L, max_abs, 256)
        adj = pw.threshold_adjust(L, max_abs, 256)
        margin = pw.extra_threshold_margin(L, max_abs, 256)
        if need >= float(pw.SLACK_ABS):
            assert adj == -margin
        else:
            eff = float(pw.SLACK_ABS) - 0.1 * adj
            assert eff >= max(1.0, min(2.0 * need, float(pw.SLACK_ABS))) \
                - 1e-9
            assert eff >= need


# ------------------------------------------- staging decompose placement (r5)

def test_stage_decompose_device_mode_oracle(tmp_path, monkeypatch):
    """MVS_STAGE_DECOMPOSE=device stages raw int32 chunks and decomposes
    limbs ON DEVICE (the locally-attached-host fast path: PCIe moves GB/s
    while single-core numpy decompose runs ~30 MB/s); output must stay
    oracle-equal and the mode must be recorded."""
    monkeypatch.setenv("MVS_STAGE_DECOMPOSE", "device")
    mc._RESIDENT.clear()   # staged planes are keyed by db, not by mode
    rng = np.random.default_rng(82)
    n, d = 192, 128
    V = rng.integers(-1200, 1201, size=(n, d)).astype(np.int32)
    V[5] = V[4]
    db = DbFolder.write(str(tmp_path / "db"), [f"S{i}" for i in range(n)],
                        V, d)
    mc.compute_pairwise_shard(db.path, str(tmp_path / "m"), tile_rows=64,
                              verbose=False)
    assert mc.LAST_STAGES["stage_decompose_mode"] == "device"
    _, norms = db.names_and_norms()
    assert_matrix_matches_oracle(V, norms * norms, d, str(tmp_path / "m"), n)
    mc._RESIDENT.clear()


def test_compact_hits_packed_buffer_and_overflow_count():
    """_compact_hits returns ONE packed int32 buffer
    [count, q, idx, ip_bits, partials...]; when the true hit count exceeds
    cap, buf[0] still reports it (the caller's retry signal) while the
    arrays carry the first cap hits."""
    from metagenome_vector_sketches_tpu.ann.search import _compact_hits
    B, k, P = 4, 8, 3
    rng = np.random.default_rng(7)
    D = jnp.asarray(np.full((B, k), 0.9, np.float32))
    I = jnp.asarray(np.arange(B * k, dtype=np.int32).reshape(B, k))
    qn = jnp.asarray(np.full(B, 10.0, np.float32))
    nn = jnp.asarray(np.full(B * k, 10.0, np.float32))
    nb = jnp.asarray(np.full(B, k, np.int32))
    Pp = jnp.asarray(rng.integers(-1000, 1000, size=(P, B, k)).astype(np.int32))
    cap = 8                       # true count = B*k = 32 > cap
    buf = np.asarray(_compact_hits(D, I, qn, nn, np.float32(0.1), nb, cap,
                                   Pp))
    assert buf.shape == (1 + (3 + P) * cap,)
    assert buf[0] == B * k        # overflow reported
    np.testing.assert_array_equal(buf[1 + cap:1 + cap + cap],
                                  np.arange(cap))          # first cap idx
    # ip bits round-trip to the scores
    ips = buf[1 + 2 * cap:1 + 3 * cap].view(np.float32)
    np.testing.assert_allclose(ips, 0.9, rtol=1e-6)
    # partials ride in (P, cap) layout matching the kept ranks
    parts = buf[1 + 3 * cap:].reshape(P, cap)
    np.testing.assert_array_equal(parts, np.asarray(Pp).reshape(P, -1)[:, :cap])
    # retry at the reported size returns the complete set
    cap2 = 32
    buf2 = np.asarray(_compact_hits(D, I, qn, nn, np.float32(0.1), nb, cap2,
                                    Pp))
    assert buf2[0] == B * k
    np.testing.assert_array_equal(buf2[1 + cap2:1 + 2 * cap2],
                                  np.arange(B * k))
