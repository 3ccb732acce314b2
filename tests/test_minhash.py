"""MinHash strategy (exact set Jaccard, the reference's historical
--strategy 1): device incidence matmuls vs python set brute force."""

import numpy as np

from metagenome_vector_sketches_tpu.ops import minhash
from metagenome_vector_sketches_tpu.io.hashes import parse_hashes_file


def test_intersections_match_python_sets():
    rng = np.random.default_rng(61)
    sets_ = [rng.choice(5000, size=rng.integers(10, 400), replace=False)
             .astype(np.uint64) for _ in range(20)]
    inter = minhash.pairwise_intersections(sets_, chunk=512)
    py = [set(int(x) for x in s) for s in sets_]
    for i in range(20):
        for j in range(20):
            assert inter[i, j] == len(py[i] & py[j])


def test_jaccard_matches_python_sets(ref_toy_dir):
    named = parse_hashes_file(str(ref_toy_dir / "all_hashes_toy.txt"))[:12]
    sets_ = [h for _, h in named]
    jac, sizes = minhash.pairwise_jaccard_minhash(sets_)
    py = [set(int(x) for x in s) for s in sets_]
    for i in range(12):
        for j in range(12):
            u = len(py[i] | py[j])
            want = len(py[i] & py[j]) / u if u else 0.0
            assert abs(jac[i, j] - want) < 1e-12


def test_minhash_shard_cli(tmp_path, ref_toy_dir):
    from metagenome_vector_sketches_tpu.cli.pairwise_comp import main
    from metagenome_vector_sketches_tpu.matrix.reader import MatrixReader
    from metagenome_vector_sketches_tpu.query import engine
    from metagenome_vector_sketches_tpu.io.dbfolder import DbFolder

    hashes = str(ref_toy_dir / "all_hashes_toy.txt")
    out = str(tmp_path / "mh")
    rc = main(["--db", str(ref_toy_dir / "toy_db_256"),
               "--max_memory_gb", "1", "--num_threads", "1",
               "--output_folder", out, "--num_shards", "1", "--shard_idx", "0",
               "--strategy", "1", "--hashes", hashes])
    assert rc == 0

    db = DbFolder(str(ref_toy_dir / "toy_db_256"))
    identifiers, norms = db.names_and_norms_f32()
    results = engine.query(out, [10], norms, identifiers)
    assert results[0].neighbor_ids  # self at least
    # top hit is self with exact J == 1 -> q = 255
    assert results[0].neighbor_ids[0] == identifiers[10]
    assert results[0].jaccard_similarities[0] == np.float32(1.0)

    # quantized values equal exact set jaccard quantized
    named = dict(parse_hashes_file(hashes))
    reader = MatrixReader(out)
    cols, q = reader.shard(0).decode_row(10)
    s10 = set(int(x) for x in named[identifiers[10]])
    for c, qq in zip(cols, q):
        sc = set(int(x) for x in named[identifiers[int(c)]])
        true_j = len(s10 & sc) / len(s10 | sc)
        assert int(qq) == int(np.floor(true_j * 255 + 0.5))
