"""End-to-end scale test at 100k+ accessions (BASELINE.json config:
"FAISS-style ANN index build + batched NN search at 100k+ accessions", and
the pairwise engine at production scale).

Generates a clustered synthetic database (so the pairwise matrix is
non-trivially sparse), then runs the real pipeline: db folder -> one
pairwise shard -> top-k queries -> ANN index + search. Prints a JSON
summary.

Run: python benchmarks/scale_test.py [N] [d] [num_shards] [host|project]

The last arg picks the generator: `host` (default) builds clustered int32
vectors directly in numpy; `project` builds clustered HASH SETS and runs
the real device projection (exercises the full ingest math, but pulls
N*d*4 bytes of device-produced vectors back to the host for the db write).
"""

import json
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def synth_vectors(n, d, n_clusters=500, hashes_per_set=2048, overlap=0.5,
                  seed=0):
    """Sketch vectors of clustered synthetic hash sets, computed directly on
    device: each accession = `overlap` of its cluster's base set + unique
    hashes. Returns (vectors int32 (n,d), cluster_id (n,))."""
    import jax.numpy as jnp
    from metagenome_vector_sketches_tpu.ops.projection import project_device_batch
    from metagenome_vector_sketches_tpu.ops.splitmix import split_u64

    rng = np.random.default_rng(seed)
    base = rng.integers(0, 1 << 63, size=(n_clusters, hashes_per_set),
                        dtype=np.uint64)
    cluster = rng.integers(0, n_clusters, size=n)
    n_shared = int(hashes_per_set * overlap)
    out = np.zeros((n, d), dtype=np.int32)
    B = 256
    for s in range(0, n, B):
        e = min(s + B, n)
        batch = np.empty((e - s, hashes_per_set), dtype=np.uint64)
        batch[:, :n_shared] = base[cluster[s:e], :n_shared]
        batch[:, n_shared:] = rng.integers(
            0, 1 << 63, size=(e - s, hashes_per_set - n_shared), dtype=np.uint64)
        hi, lo = split_u64(batch)
        counts = np.full(e - s, hashes_per_set, dtype=np.int32)
        out[s:e] = np.asarray(project_device_batch(
            jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(counts), d))
    return out, cluster


def synth_vectors_host(n, d, n_clusters=None, seed=0, max_mag=1200,
                       noise=40):
    """Clustered int32 sketch-like vectors built directly on the host (no
    projection, no device transfers) — the default generator."""
    rng = np.random.default_rng(seed)
    if n_clusters is None:
        n_clusters = max(1, n // 2)
    protos = rng.integers(-max_mag, max_mag + 1, size=(n_clusters, d),
                          dtype=np.int32)
    cluster = rng.integers(0, n_clusters, size=n)
    out = protos[cluster] + rng.integers(-noise, noise + 1,
                                         size=(n, d)).astype(np.int32)
    return out, cluster


def main():
    N = int(sys.argv[1]) if len(sys.argv) > 1 else 100_000
    d = int(sys.argv[2]) if len(sys.argv) > 2 else 2048
    num_shards = int(sys.argv[3]) if len(sys.argv) > 3 else 8
    synth_mode = sys.argv[4] if len(sys.argv) > 4 else "host"
    if synth_mode not in ("host", "project"):
        raise SystemExit(f"unknown synth mode {synth_mode!r}: "
                         "expected 'host' or 'project'")

    from metagenome_vector_sketches_tpu.io.dbfolder import DbFolder
    from metagenome_vector_sketches_tpu.matrix.compute import compute_pairwise_shard
    from metagenome_vector_sketches_tpu.matrix.reader import MatrixReader
    from metagenome_vector_sketches_tpu.query import engine
    from metagenome_vector_sketches_tpu.ann.flat_index import index_vectors, FlatIPIndex, normalize_l2

    tmp = tempfile.mkdtemp(prefix="mvs_scale_")
    summary = {"N": N, "d": d, "num_shards": num_shards}
    try:
        t0 = time.perf_counter()
        if synth_mode == "project":
            vectors, cluster = synth_vectors(N, d)
        else:
            vectors, cluster = synth_vectors_host(N, d)
        summary["synth_s"] = round(time.perf_counter() - t0, 2)

        t0 = time.perf_counter()
        names = [f"ACC{i:07d}" for i in range(N)]
        db = DbFolder.write(os.path.join(tmp, "db"), names, vectors, d)
        summary["db_write_s"] = round(time.perf_counter() - t0, 2)

        t0 = time.perf_counter()
        shard = compute_pairwise_shard(db.path, os.path.join(tmp, "matrix"),
                                       num_shards=num_shards, shard_idx=0,
                                       tile_rows=512, verbose=True)
        dt = time.perf_counter() - t0
        rows_in_shard = (N + num_shards - 1) // num_shards
        summary["pairwise_shard0_s"] = round(dt, 2)
        summary["pairwise_pairs_per_s"] = round(rows_in_shard * N / dt, 0)

        reader = MatrixReader(os.path.join(tmp, "matrix"))
        r, c, q = reader.decode_all_triples(N)
        summary["shard0_pairs"] = int(len(r))

        t0 = time.perf_counter()
        identifiers, norms = db.names_and_norms_f32()
        queries = list(range(0, min(1000, rows_in_shard)))
        results = engine.query(os.path.join(tmp, "matrix"), queries, norms,
                               identifiers)
        summary["query_1000_s"] = round(time.perf_counter() - t0, 2)
        summary["avg_neighbors"] = round(
            float(np.mean([len(res.neighbor_ids) for res in results])), 1)

        t0 = time.perf_counter()
        index_vectors(db.path, verbose=False)
        summary["ann_index_s"] = round(time.perf_counter() - t0, 2)
        idx = FlatIPIndex.load(os.path.join(db.path, "faiss.index"))
        Q = normalize_l2(vectors[:256].astype(np.float32))
        t0 = time.perf_counter()
        D, I = idx.search(Q, 50)
        summary["ann_search_256q_s"] = round(time.perf_counter() - t0, 2)
        # quality: top-1 self (N may be < 256, so size from Q)
        summary["ann_top1_self_frac"] = float(
            np.mean(I[:, 0] == np.arange(len(Q))))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
