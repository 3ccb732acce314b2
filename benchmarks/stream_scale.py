"""Beyond-HBM streaming benchmark at production scale.

The reference routinely operates at N >= 7e5 accessions via
--max_memory_gb chunking (/root/reference/src/pairwise_comp_optimized.cpp
:903-906, 949-982; server neighbor ids at query_ava_matrix.cpp:280,598).
This harness measures the analogous path here on real hardware:

  1. builds an N x d clustered synthetic db ON DISK (chunked writes — no
     full host array),
  2. runs ONE pairwise shard with a device budget that forces
     _compute_streaming_fused (row groups resident, column windows
     streamed), recording the honest per-stage split,
  3. optionally runs the same shard device-resident (the planes of a 1M x
     2048 int32 db are ~6 GB at L=2, so streaming is only forced by a
     smaller budget), for the crossover comparison,
  4. spot-checks PARITY: a few sampled rows are recomputed against the
     float64/int64 oracle from the on-disk vectors.

Run: python benchmarks/stream_scale.py [N] [d] [num_shards]
         [budget_gb] [mode]
  mode: stream (default) | resident | both
"""

import json
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def build_db_on_disk(path, N, d, n_clusters=None, seed=0, max_mag=1200,
                     noise=40, chunk=65536):
    """Clustered synthetic db written straight to disk in chunks."""
    from metagenome_vector_sketches_tpu.io.dbfolder import DbFolder
    rng = np.random.default_rng(seed)
    if n_clusters is None:
        n_clusters = max(1, N // 2)
    protos = rng.integers(-max_mag, max_mag + 1, size=(n_clusters, d),
                          dtype=np.int32)
    cluster = rng.integers(0, n_clusters, size=N)
    os.makedirs(path, exist_ok=True)
    norms = np.empty(N, dtype=np.float64)
    max_abs = 0
    with open(os.path.join(path, "vectors.bin"), "wb") as f:
        for s in range(0, N, chunk):
            e = min(s + chunk, N)
            block = protos[cluster[s:e]] + rng.integers(
                -noise, noise + 1, size=(e - s, d)).astype(np.int32)
            norms[s:e] = np.sqrt(np.einsum(
                "ij,ij->i", block.astype(np.float64),
                block.astype(np.float64)) / d)
            max_abs = max(max_abs, int(np.abs(block).max()))
            f.write(block.tobytes())
    with open(os.path.join(path, "vector_norms.txt"), "w") as f:
        for i in range(N):
            f.write(f"ACC{i:07d} {norms[i]:.6f}\n")
    with open(os.path.join(path, "dimension.txt"), "w") as f:
        f.write(f"{d}\n")
    with open(os.path.join(path, "dtype.txt"), "w") as f:
        f.write("int32\n")
    with open(os.path.join(path, "max_component.txt"), "w") as f:
        f.write(f"{max_abs}\n")
    return cluster


def spot_check(db_path, matrix_path, N, d, n_rows=3, seed=1,
               row_range=None):
    """Sampled-row parity vs the exact float64/int64 oracle. Rows are
    sampled inside row_range (the shard's row span — other rows are not
    in this shard's folder)."""
    from metagenome_vector_sketches_tpu.io.dbfolder import DbFolder
    from metagenome_vector_sketches_tpu.matrix.reader import MatrixReader
    from metagenome_vector_sketches_tpu.matrix.writer import quantize_jaccard
    db = DbFolder(db_path)
    _, norms = db.names_and_norms()
    ns = norms * norms
    Vmm = np.memmap(os.path.join(db_path, "vectors.bin"), dtype=np.int32,
                    mode="r", shape=(N, d))
    reader = MatrixReader(matrix_path)
    rng = np.random.default_rng(seed)
    lo, hi = row_range if row_range else (0, N)
    rows = sorted(int(r) for r in
                  rng.choice(np.arange(lo, hi), size=n_rows, replace=False))
    decoded = reader.load_neighbors_for_rows(rows, N)
    # all sampled rows' int64 dots in one pass over the db. float64 BLAS is
    # integer-exact while every |dot| <= d * max|v|^2 stays below 2^53;
    # past that bound the dots are taken in int64 arithmetic instead
    max_abs = db.max_component()
    exact_f64 = max_abs is not None and d * max_abs * max_abs < 2**53
    R = np.asarray(Vmm[rows], dtype=np.float64 if exact_f64 else np.int64)
    all_dots = np.empty((N, len(rows)), dtype=np.int64)
    B = 65536
    for s in range(0, N, B):
        blk = np.asarray(Vmm[s:s + B], dtype=R.dtype)
        all_dots[s:s + B] = np.rint(blk @ R.T) if exact_f64 else blk @ R.T
    ok = True
    for k, (row, dec) in enumerate(zip(rows, decoded)):
        dots = all_dots[:, k]
        q = np.where(dots >= 0, dots // d, -((-dots) // d))
        keep = q.astype(np.float64) > 0.05 * (ns[row] + ns)
        cols = np.flatnonzero(keep)
        want_q = quantize_jaccard(dots[cols], np.full(len(cols), row),
                                  cols, ns, d)
        if dec is None:
            ok = ok and len(cols) == 0
            continue
        got_cols, got_q = dec
        ok = ok and np.array_equal(np.asarray(got_cols), cols) \
            and np.array_equal(np.asarray(got_q, dtype=np.uint16), want_q)
    return ok


def main():
    N = int(sys.argv[1]) if len(sys.argv) > 1 else 1_048_576
    d = int(sys.argv[2]) if len(sys.argv) > 2 else 2048
    num_shards = int(sys.argv[3]) if len(sys.argv) > 3 else 16
    budget_gb = float(sys.argv[4]) if len(sys.argv) > 4 else 2.0
    mode = sys.argv[5] if len(sys.argv) > 5 else "stream"
    # optional persistent db dir: reused across invocations (an 8.6 GB
    # synthetic db takes minutes to regenerate); matrix outputs still go
    # to a throwaway tmp dir
    db_dir = sys.argv[6] if len(sys.argv) > 6 else None
    repeats = int(os.environ.get("STREAM_SCALE_REPEATS", "2"))

    from metagenome_vector_sketches_tpu.matrix import compute as mc

    tmp = tempfile.mkdtemp(prefix="mvs_stream_", dir="/tmp")
    summary = {"N": N, "d": d, "num_shards": num_shards,
               "budget_gb": budget_gb}
    rows_in_shard = (N + num_shards - 1) // num_shards
    try:
        db_path = db_dir or os.path.join(tmp, "db")
        if db_dir and os.path.exists(os.path.join(db_dir, "dtype.txt")):
            # A reused dir must actually hold the requested database:
            # a stale dir of different (N, d) would silently compute
            # over the wrong rows while the summary reports the
            # requested pair count (inflated/deflated pairs_per_sec).
            vec_bytes = os.path.getsize(os.path.join(db_dir, "vectors.bin"))
            if vec_bytes != N * d * 4:
                raise SystemExit(
                    f"reused db dir {db_dir} holds "
                    f"{vec_bytes // (d * 4)} rows at d={d} "
                    f"(vectors.bin {vec_bytes} B), not the requested "
                    f"N={N}; pass a fresh dir or matching N/d")
            summary["db_build_s"] = 0.0  # reused
        else:
            t0 = time.perf_counter()
            build_db_on_disk(db_path, N, d)
            summary["db_build_s"] = round(time.perf_counter() - t0, 1)
        print("STREAM_SCALE_DB " + json.dumps(summary), flush=True)

        runs = ["stream", "resident"] if mode == "both" else [mode]
        for run in runs:
            budget = int(budget_gb * (1 << 30)) if run == "stream" \
                else None
            out_dir = os.path.join(tmp, f"matrix_{run}")
            walls = []
            try:
                # repeat: first wall carries cold compiles; the last is
                # warm
                for r in range(max(1, repeats)):
                    if r:
                        shutil.rmtree(out_dir, ignore_errors=True)
                    t0 = time.perf_counter()
                    mc.compute_pairwise_shard(
                        db_path, out_dir, num_shards=num_shards,
                        shard_idx=0, tile_rows=2048,
                        device_budget_bytes=budget, verbose=True)
                    walls.append(time.perf_counter() - t0)
            except Exception as err:
                summary[run] = {"error": f"{type(err).__name__}: "
                                f"{str(err)[:300]}"}
                print("STREAM_SCALE_RUN " + json.dumps(
                    {run: summary[run]}), flush=True)
                mc.clear_device_cache()
                continue
            dt = walls[-1]
            st = dict(mc.LAST_STAGES)
            summary[run] = {
                "walls_s": [round(w, 1) for w in walls],
                "wall_s": round(dt, 1),
                "pairs": rows_in_shard * N,
                "pairs_per_sec": round(rows_in_shard * N / dt, 0),
                "mode": st.get("mode"),
                "candidates": int(st.get("candidates", 0)),
                "pairs_written": int(st.get("pairs_written", 0)),
                "stage_split_ms": {
                    k: round(float(st.get(k, 0.0)), 0)
                    for k in ("stage_ms", "sweep_ms", "extract_ms",
                              "finalize_ms", "write_ms",
                              "stage_decompose_ms")},
            }
            summary[run]["spot_check_ok"] = spot_check(
                db_path, out_dir, N, d, row_range=(0, rows_in_shard))
            print("STREAM_SCALE_RUN " + json.dumps({run: summary[run]}),
                  flush=True)
            mc.clear_device_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print("STREAM_SCALE " + json.dumps(summary))


if __name__ == "__main__":
    main()
