"""ANN path gates (SURVEY.md §7.3 step 5): flat-IP index exactness vs numpy
brute force, index persistence, and search-pipeline neighbor parity against
true Jaccard on toy."""

import os
import shutil

import numpy as np
import pytest

from metagenome_vector_sketches_tpu.ann.flat_index import (
    FlatIPIndex, normalize_l2, index_vectors,
)
from metagenome_vector_sketches_tpu.ann import search as ann_search
from metagenome_vector_sketches_tpu.io.dbfolder import DbFolder
from metagenome_vector_sketches_tpu.io.hashes import parse_hashes_file


def test_flat_index_matches_bruteforce():
    rng = np.random.default_rng(21)
    V = normalize_l2(rng.normal(size=(500, 64)).astype(np.float32))
    Q = normalize_l2(rng.normal(size=(7, 64)).astype(np.float32))
    idx = FlatIPIndex(V, chunk_rows=128)  # force multi-chunk merge
    D, I = idx.search(Q, 10)
    scores = Q.astype(np.float64) @ V.astype(np.float64).T
    for qi in range(7):
        want = np.argsort(-scores[qi], kind="stable")[:10]
        got_set, want_set = set(I[qi].tolist()), set(want.tolist())
        # allow reordering only among exact ties
        assert got_set == want_set or np.allclose(
            np.sort(scores[qi][list(got_set)]), np.sort(scores[qi][list(want_set)]),
            rtol=1e-6)
        assert np.all(np.diff(D[qi]) <= 1e-6)


def test_flat_index_recall_target_mode():
    """recall_target < 1.0 (approx_max_k path) still returns well-formed,
    high-recall results; exact on CPU where approx_max_k reduces to sort."""
    rng = np.random.default_rng(22)
    V = normalize_l2(rng.normal(size=(500, 64)).astype(np.float32))
    Q = normalize_l2(rng.normal(size=(7, 64)).astype(np.float32))
    exact = FlatIPIndex(V, chunk_rows=128)
    approx = FlatIPIndex(V, chunk_rows=128, recall_target=0.95)
    De, Ie = exact.search(Q, 10)
    Da, Ia = approx.search(Q, 10)
    for qi in range(7):
        assert np.all(np.diff(Da[qi]) <= 1e-6)
        overlap = len(set(Ie[qi].tolist()) & set(Ia[qi].tolist()))
        assert overlap >= 9  # >= 90% recall at these sizes


def test_adaptive_expansion_goes_deeper():
    """A database with > 50 near-identical rows must trigger the 50*3^i
    expansion and still return every above-threshold neighbor."""
    from metagenome_vector_sketches_tpu.ann.search import adaptive_search, rescore
    rng = np.random.default_rng(24)
    d, n_close = 64, 180                   # 180 > 50 forces level >= 1
    base = rng.normal(size=d).astype(np.float32)
    close = base[None, :] + 0.01 * rng.normal(size=(n_close, d)).astype(np.float32)
    far = rng.normal(size=(300, d)).astype(np.float32)
    V = np.concatenate([close, far])
    # norms follow the real pipeline convention: pre-normalization vector
    # norms (queries and db share the projection, so scales are comparable)
    norms = np.linalg.norm(V, axis=1).astype(np.float64)
    idx = FlatIPIndex(normalize_l2(V), chunk_rows=128)
    queries = base[None, :].astype(np.float64)
    hits, qn = adaptive_search(idx, queries, j=0.3, verbose=False,
                               db_norms=norms)
    out = rescore(hits, qn, [f"A{i}" for i in range(len(V))], norms,
                  j=0.3, verbose=False)
    mine = {nid for (q, nid, jac) in out}
    # the CLOSE rows specifically must be found (far-row false positives
    # must not mask a recall loss), despite exceeding the initial k=50
    close_found = sum(1 for i in range(n_close) if f"A{i}" in mine)
    assert close_found >= n_close - 2, close_found


def test_flat_index_k_exceeds_ntotal():
    rng = np.random.default_rng(22)
    V = normalize_l2(rng.normal(size=(5, 16)).astype(np.float32))
    idx = FlatIPIndex(V)
    D, I = idx.search(V[:2], 50)
    assert I.shape == (2, 50)
    assert np.all(I[:, 5:] == -1)
    assert np.all(D[:, 5:] == 0.0)


def test_index_save_load_round_trip(tmp_path, ref_toy_dir):
    db_src = str(ref_toy_dir / "toy_db_256")
    db_dir = tmp_path / "db"
    shutil.copytree(db_src, db_dir)
    path = index_vectors(str(db_dir), verbose=False)
    assert os.path.basename(path) == "faiss.index"
    idx = FlatIPIndex.load(path)
    assert idx.ntotal == 61 and idx.d == 256
    # self-search: each vector's own index is its top hit (ip ~= 1)
    D, I = idx.search(idx.vectors[:10], 1)
    np.testing.assert_array_equal(I[:, 0], np.arange(10))
    assert np.all(D[:, 0] > 0.999)


@pytest.fixture(scope="module")
def toy_index_2048(tmp_path_factory, ref_toy_dir):
    db_dir = tmp_path_factory.mktemp("annd") / "db"
    shutil.copytree(str(ref_toy_dir / "toy_db_2048"), db_dir)
    index_vectors(str(db_dir), verbose=False)
    return str(db_dir) + "/"


def test_search_pipeline_recovers_true_neighbors(toy_index_2048, ref_toy_dir,
                                                 tmp_path):
    """End-to-end jaccard-search on toy: estimated neighbors above j=0.1 must
    match true hash-set Jaccard within the estimator's accuracy envelope
    (the reference's own validation approach, jaccard.py test():226-325)."""
    named = parse_hashes_file(str(ref_toy_dir / "all_hashes_toy.txt"))
    hashes = dict(named)
    db = DbFolder(toy_index_2048)
    names, _ = db.names_and_norms()
    take = names[:6]
    qf = tmp_path / "q.txt"
    with open(qf, "w") as f:
        for n in take:
            f.write(f"{n}: " + " ".join(str(h) for h in hashes[n]) + "\n")
    results = ann_search.search_index(toy_index_2048, str(qf), 0.1,
                                      verbose=False)
    by_query = {}
    for qi, nid, jac in results:
        by_query.setdefault(qi, []).append((nid, jac))
    for qi, name in enumerate(take):
        got = dict(by_query.get(qi, []))
        # self hit with jaccard ~1
        assert got.get(name, 0) > 0.9, (name, got)
        # estimated vs true jaccard within RMSE envelope (~0.03 at d=2048)
        s1 = set(int(h) for h in hashes[name])
        for nid, est in got.items():
            s2 = set(int(h) for h in hashes[nid])
            true = len(s1 & s2) / len(s1 | s2)
            assert abs(est - true) < 0.12, (name, nid, est, true)


def test_search_pipeline_int8_engine_matches_f32(toy_index_2048,
                                                 ref_toy_dir, tmp_path):
    """engine='int8' (int8-plane exact engine, no faiss.index involved)
    must return the same neighbors as the FAISS-parity f32 path on toy,
    with jaccards agreeing to f32 accuracy (the int engine's scores are
    float64-exact; the f32 path's carry HIGHEST-matmul rounding)."""
    named = parse_hashes_file(str(ref_toy_dir / "all_hashes_toy.txt"))
    hashes = dict(named)
    db = DbFolder(toy_index_2048)
    names, _ = db.names_and_norms()
    take = names[:5]
    qf = tmp_path / "q.txt"
    with open(qf, "w") as f:
        for n in take:
            f.write(f"{n}: " + " ".join(str(h) for h in hashes[n]) + "\n")
    ref = ann_search.search_index(toy_index_2048, str(qf), 0.1,
                                  verbose=False)
    got = ann_search.search_index(toy_index_2048, str(qf), 0.1,
                                  verbose=False, engine="int8")
    ref_map = {(q, nid): jac for q, nid, jac in ref}
    got_map = {(q, nid): jac for q, nid, jac in got}
    assert set(ref_map) == set(got_map)
    for key in ref_map:
        assert abs(ref_map[key] - got_map[key]) < 1e-3, key


def test_search_pipeline_mesh_sharded_matches_single(toy_index_2048,
                                                     ref_toy_dir, tmp_path):
    """mesh_devices=8 (rows/chunks scattered over the virtual mesh, pools
    merged over the mesh axis) must return IDENTICAL neighbor sets for
    BOTH serving engines — the adaptive expansion decisions and the final
    rescoring see the same scores, so any divergence is a sharding bug."""
    import jax
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    named = parse_hashes_file(str(ref_toy_dir / "all_hashes_toy.txt"))
    hashes = dict(named)
    db = DbFolder(toy_index_2048)
    names, _ = db.names_and_norms()
    take = names[:4]
    qf = tmp_path / "q.txt"
    with open(qf, "w") as f:
        for n in take:
            f.write(f"{n}: " + " ".join(str(h) for h in hashes[n]) + "\n")
    for engine in ("f32", "int8"):
        ref = ann_search.search_index(toy_index_2048, str(qf), 0.1,
                                      verbose=False, engine=engine)
        got = ann_search.search_index(toy_index_2048, str(qf), 0.1,
                                      verbose=False, engine=engine,
                                      mesh_devices=8)
        ref_map = {(q, nid): jac for q, nid, jac in ref}
        got_map = {(q, nid): jac for q, nid, jac in got}
        assert set(ref_map) == set(got_map), engine
        for key in ref_map:
            assert abs(ref_map[key] - got_map[key]) < 1e-6, (engine, key)


def test_jaccard_cli(toy_index_2048, ref_toy_dir, tmp_path, capsys):
    from metagenome_vector_sketches_tpu.cli.jaccard import main
    named = dict(parse_hashes_file(str(ref_toy_dir / "all_hashes_toy.txt")))
    name = next(iter(named))
    qf = tmp_path / "q.txt"
    qf.write_text(f"{name}: " + " ".join(str(h) for h in named[name]) + "\n")
    rc = main(["search", toy_index_2048.rstrip("/"), str(qf), "-j", "0.2"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "Query 0:" in out and name in out
    # mesh-sharded serving from the CLI flag (0 = all local devices)
    import jax
    if len(jax.devices()) >= 8:
        rc = main(["search", toy_index_2048.rstrip("/"), str(qf),
                   "-j", "0.2", "--engine", "int8", "--mesh_devices", "0"])
        assert rc == 0
        out2 = capsys.readouterr().out
        assert "Query 0:" in out2 and name in out2


def test_from_device_chunks_matches_host_index():
    """Device-side index construction (benchmarks/ann_scale.py path): an index
    over device-resident chunks returns the same results as the host-vector
    index; save() on it is refused."""
    import jax.numpy as jnp
    from metagenome_vector_sketches_tpu.ann.flat_index import (
        FlatIPIndex, normalize_l2)
    rng = np.random.default_rng(51)
    N, d, B, k = 300, 32, 4, 7
    V = normalize_l2(rng.normal(size=(N, d)).astype(np.float32))
    Q = normalize_l2(rng.normal(size=(B, d)).astype(np.float32))
    host = FlatIPIndex(V, chunk_rows=128)
    chunks = [(s, jnp.asarray(V[s:s + 128])) for s in range(0, N, 128)]
    dev = FlatIPIndex.from_device_chunks(chunks, d)
    assert dev.ntotal == N and dev.d == d
    D1, I1 = host.search(Q, k)
    D2, I2 = dev.search(Q, k)
    np.testing.assert_array_equal(I1, I2)
    np.testing.assert_allclose(D1, D2, rtol=1e-6)
    with pytest.raises(ValueError):
        dev.save("/tmp/should_not_exist.index")


# ---------------------------------------------------------------------------
# genuine FAISS faiss.index byte-format interop
# ---------------------------------------------------------------------------

def _golden_faiss_flat_ip(vectors):
    """Hand-packed bytes exactly as faiss.write_index emits for an
    IndexFlatIP (faiss/impl/index_write.cpp; layout independent of our
    implementation — this is the format spec, not a round-trip)."""
    import struct
    n, d = vectors.shape
    out = b"IxFI"
    out += struct.pack("<i", d)
    out += struct.pack("<q", n)
    out += struct.pack("<qq", 1 << 20, 1 << 20)   # legacy dummies
    out += struct.pack("<B", 1)                    # is_trained
    out += struct.pack("<i", 0)                    # METRIC_INNER_PRODUCT
    out += struct.pack("<Q", n * d)
    out += np.ascontiguousarray(vectors, dtype="<f4").tobytes()
    return out


def test_faiss_flat_ip_bytes_load_and_search(tmp_path):
    """Bytes as written by faiss.write_index(IndexFlatIP) must load into
    FlatIPIndex and search identically to an index built from the same
    vectors (reference artifact contract, jaccard.py:59-61, 120-124)."""
    rng = np.random.default_rng(71)
    V = normalize_l2(rng.normal(size=(37, 16)).astype(np.float32))
    Q = normalize_l2(rng.normal(size=(5, 16)).astype(np.float32))
    path = str(tmp_path / "faiss.index")
    with open(path, "wb") as f:
        f.write(_golden_faiss_flat_ip(V))
    idx = FlatIPIndex.load(path)
    assert (idx.ntotal, idx.d) == (37, 16)
    Df, If = idx.search(Q, 7)
    Dr, Ir = FlatIPIndex(V).search(Q, 7)
    np.testing.assert_array_equal(If, Ir)
    np.testing.assert_array_equal(Df, Dr)


def test_faiss_flat_write_is_byte_identical_to_faiss(tmp_path):
    """Our save() output must be the exact bytes faiss.write_index would
    produce — so the index is inspectable with stock FAISS tooling."""
    rng = np.random.default_rng(72)
    V = normalize_l2(rng.normal(size=(11, 8)).astype(np.float32))
    idx = FlatIPIndex(V)
    path = str(tmp_path / "faiss.index")
    idx.save(path)
    assert open(path, "rb").read() == _golden_faiss_flat_ip(V)


def test_faiss_flat_l2_and_errors(tmp_path):
    from metagenome_vector_sketches_tpu.ann import faissio
    rng = np.random.default_rng(73)
    V = rng.normal(size=(4, 6)).astype(np.float32)
    p = str(tmp_path / "l2.index")
    faissio.write_flat(p, V, metric=faissio.METRIC_L2)
    got, metric = faissio.read_flat(p)
    assert metric == faissio.METRIC_L2
    np.testing.assert_array_equal(got, V)
    # non-flat FAISS index (e.g. IVF fourcc) -> informative refusal
    bad = str(tmp_path / "ivf.index")
    with open(bad, "wb") as f:
        f.write(b"IwFl" + b"\x00" * 64)
    with pytest.raises(ValueError, match="IndexFlat"):
        FlatIPIndex.load(bad)
    # truncated data -> refusal
    trunc = str(tmp_path / "trunc.index")
    with open(trunc, "wb") as f:
        f.write(_golden_faiss_flat_ip(V)[:-8])
    with pytest.raises(ValueError, match="truncated"):
        faissio.read_flat(trunc)
    # truncated AT or INSIDE the u64 count field (e.g. interrupted copy
    # right after the 33-byte header) -> ValueError, not struct.error
    full = _golden_faiss_flat_ip(V)
    for cut in (4 + 33, 4 + 33 + 3):
        t2 = str(tmp_path / f"trunc{cut}.index")
        with open(t2, "wb") as f:
            f.write(full[:cut])
        with pytest.raises(ValueError, match="truncated"):
            faissio.read_flat(t2)


def test_mvsflatip_backcompat_load(tmp_path):
    """Round-2 private-format artifacts must still load (autodetect)."""
    import struct
    rng = np.random.default_rng(74)
    V = normalize_l2(rng.normal(size=(9, 4)).astype(np.float32))
    path = str(tmp_path / "faiss.index")
    with open(path, "wb") as f:
        f.write(b"MVSFLATIP\x00")
        f.write(struct.pack("<I", 1))
        f.write(struct.pack("<QQ", 9, 4))
        V.tofile(f)
    idx = FlatIPIndex.load(path)
    assert (idx.ntotal, idx.d) == (9, 4)
    np.testing.assert_array_equal(idx.vectors, V)


def test_scan_topk_matches_loop_and_bf16_rescore():
    """The single-program scan search must equal the per-chunk loop path
    exactly (f32), and bf16_rescore must achieve full recall at toy scale
    with exactly-rescored scores."""
    rng = np.random.default_rng(75)
    n, d, k = 1000, 64, 10
    V = normalize_l2(rng.normal(size=(n, d)).astype(np.float32))
    Q = normalize_l2(rng.normal(size=(17, d)).astype(np.float32))
    ref = FlatIPIndex(V, chunk_rows=128)
    ref._chunk_stack = lambda: None          # force the loop path
    Dl, Il = ref.search(Q, k)
    scan = FlatIPIndex(V, chunk_rows=128)    # scan path (stack)
    Ds, Is = scan.search(Q, k)
    np.testing.assert_array_equal(Is, Il)
    np.testing.assert_allclose(Ds, Dl, rtol=1e-6, atol=1e-7)
    fast = FlatIPIndex(V, chunk_rows=128, precision="bf16_rescore")
    Df, If = fast.search(Q, k)
    # exact rescoring: scores of the common neighbors match f32 exactly
    for b in range(17):
        common = set(If[b].tolist()) & set(Il[b].tolist())
        assert len(common) >= k - 1          # bf16 pool recall
        ref_scores = dict(zip(Il[b].tolist(), Dl[b].tolist()))
        for j, idx in enumerate(If[b].tolist()):
            if idx in ref_scores:
                assert abs(Df[b, j] - ref_scores[idx]) < 1e-6


def test_from_device_chunks_bf16_store():
    """store='bf16': stacked bfloat16 store, scan search + f32-math
    rescoring; near-perfect recall vs the f32 index at toy scale."""
    import jax.numpy as jnp
    from metagenome_vector_sketches_tpu.ann.flat_index import (
        FlatIPIndex, normalize_l2)
    rng = np.random.default_rng(76)
    n, d, k = 700, 32, 10
    V = normalize_l2(rng.normal(size=(n, d)).astype(np.float32))
    R = 256
    chunks = [(s, jnp.asarray(V[s:s + R])) for s in range(0, n, R)]
    idx = FlatIPIndex.from_device_chunks(chunks, d, store="bf16")
    assert idx.precision == "bf16_rescore"
    Q = normalize_l2(rng.normal(size=(9, d)).astype(np.float32))
    Db, Ib = idx.search(Q, k)
    Df, If = FlatIPIndex(V).search(Q, k)
    for b in range(9):
        assert len(set(Ib[b].tolist()) & set(If[b].tolist())) >= k - 1


def test_faiss_header_allocation_capped(tmp_path):
    """A corrupt header claiming a huge vector count must fail with a clean
    ValueError BEFORE any allocation (np.fromfile pre-allocates count)."""
    import struct
    from metagenome_vector_sketches_tpu.ann import faissio
    p = str(tmp_path / "huge.index")
    ntotal, d = 1 << 40, 2048
    with open(p, "wb") as f:
        f.write(b"IxFI")
        f.write(struct.pack("<i", d))
        f.write(struct.pack("<q", ntotal))
        f.write(struct.pack("<qq", 1 << 20, 1 << 20))
        f.write(struct.pack("<B", 1))
        f.write(struct.pack("<i", 0))
        f.write(struct.pack("<Q", ntotal * d))
        f.write(b"\x00" * 16)                      # almost no data present
    with pytest.raises(ValueError, match="truncated or corrupt"):
        faissio.read_flat(p)


def test_flat_index_load_rejects_l2_metric(tmp_path):
    """An IndexFlatL2 file must be rejected by FlatIPIndex.load — searching
    it with inner-product semantics would be silently wrong."""
    from metagenome_vector_sketches_tpu.ann import faissio
    rng = np.random.default_rng(79)
    V = rng.normal(size=(4, 6)).astype(np.float32)
    p = str(tmp_path / "l2b.index")
    faissio.write_flat(p, V, metric=faissio.METRIC_L2)
    with pytest.raises(ValueError, match="inner-product"):
        FlatIPIndex.load(p)


def test_serving_mesh_rejects_negative():
    from metagenome_vector_sketches_tpu.ann.search import _serving_mesh
    with pytest.raises(ValueError, match="mesh_devices"):
        _serving_mesh(-4)
