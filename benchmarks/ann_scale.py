"""ANN at production scale (BASELINE.json "100k+ accessions" config):
flat-IP index build + batched top-k search and the adaptive expanding
pipeline at N=1,048,576 x d=2048 on the GPU,
with recall of the approx_max_k path verified against the exact search.

Device-side construction: the database is generated and L2-normalized ON
DEVICE (FlatIPIndex.from_device_chunks) — nothing crosses the host except
the (B, k) results. Search throughput is the marginal time of a
data-dependent chain of searches ending in one tiny host read, so
dispatch/D2H latency doesn't pollute the device number.

Run: python benchmarks/ann_scale.py [N] [d] [B] [k]
Prints one JSON line.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    N = int(sys.argv[1]) if len(sys.argv) > 1 else 1 << 20
    d = int(sys.argv[2]) if len(sys.argv) > 2 else 2048
    B = int(sys.argv[3]) if len(sys.argv) > 3 else 256
    k = int(sys.argv[4]) if len(sys.argv) > 4 else 50

    import functools
    import jax
    import jax.numpy as jnp
    from metagenome_vector_sketches_tpu.ann.flat_index import FlatIPIndex
    from metagenome_vector_sketches_tpu.utils.profiling import marginal_time

    out = {"N": N, "d": d, "B": B, "k": k,
           "backend": jax.default_backend()}

    @functools.partial(jax.jit, static_argnames=("rows", "dd"))
    def synth_chunk(key, rows, dd):
        v = jax.random.normal(key, (rows, dd), dtype=jnp.float32)
        inv = jax.lax.rsqrt(jnp.maximum(
            jnp.sum(v * v, axis=1, keepdims=True), 1e-30))
        return v * inv

    CHUNK = 65536
    t0 = time.perf_counter()
    keys = jax.random.split(jax.random.PRNGKey(0), (N + CHUNK - 1) // CHUNK)
    chunks = []
    s = 0
    while s < N:
        rows = min(CHUNK, N - s)
        chunks.append((s, synth_chunk(keys[len(chunks)], rows, d)))
        s += rows
    jax.block_until_ready([c for _, c in chunks])
    out["build_on_device_s"] = round(time.perf_counter() - t0, 2)
    out["index_bytes"] = int(N * d * 4)

    index = FlatIPIndex.from_device_chunks(chunks, d)

    # queries: noisy copies of rows from the first chunk
    qkey = jax.random.PRNGKey(7)
    base_rows = chunks[0][1][:B]
    noise = 0.02 * jax.random.normal(qkey, (B, d), dtype=jnp.float32)
    q = base_rows + noise
    q = q * jax.lax.rsqrt(jnp.maximum(jnp.sum(q * q, axis=1,
                                              keepdims=True), 1e-30))
    q = jax.block_until_ready(q)

    def timed_search(recall):
        index.recall_target = recall
        last_I = [None]

        def chain(n):
            t0 = time.perf_counter()
            seed = jnp.float32(0)
            for _ in range(n):
                D, I = index.search_device(q + seed * 0, k)
                seed = D[0, 0]
                last_I[0] = I
            float(np.asarray(seed))
            return time.perf_counter() - t0

        w = marginal_time(chain, reps=4, rounds=3)
        return np.asarray(last_I[0]), w

    I_exact, w_exact = timed_search(1.0)
    out["exact_qps"] = round(B / w_exact, 1)
    out["exact_batch_s"] = round(w_exact, 4)
    I_appr, w_appr = timed_search(0.95)
    out["approx95_qps"] = round(B / w_appr, 1)
    hits = sum(len(set(I_appr[b]) & set(I_exact[b])) for b in range(B))
    out["approx95_recall_at_k"] = round(hits / (B * k), 4)

    # bf16-stored stack + 4k candidate pool + f32-math rescoring: the
    # serving-speed mode. EVERY f32 reference must drop first (the store
    # cast frees originals chunk by chunk; both copies cannot fit HBM at
    # N=1M): the exact index shares the chunk tuples, and store='bf16'
    # consumes the passed list in place.
    index._device_chunks = None
    index = FlatIPIndex.from_device_chunks(chunks, d, store="bf16")
    assert len(chunks) == 0          # consumed
    I_bf, w_bf = timed_search(1.0)
    out["bf16_rescore_qps"] = round(B / w_bf, 1)
    hits = sum(len(set(I_bf[b]) & set(I_exact[b])) for b in range(B))
    out["bf16_rescore_recall_at_k"] = round(hits / (B * k), 4)

    # self-neighbor sanity: each noisy query's source row in the exact top-k
    out["self_in_topk"] = round(
        float(np.mean([b in set(I_exact[b].tolist()) for b in range(B)])), 3)

    # adaptive expanding pipeline (reference jaccard.py:120-174 semantics)
    from metagenome_vector_sketches_tpu.ann.search import adaptive_search
    rng = np.random.default_rng(3)
    norms = rng.uniform(40.0, 80.0, size=N)  # plausible |A|~1.6k-6.4k norms
    nq = 32
    # query norms must live on the db-norm scale for the jaccard
    # estimate to clear j (norm^2 ~ |set|): scale the unit queries
    Qh = np.asarray(q[:nq]).astype(np.float64) * 60.0
    t0 = time.perf_counter()
    hits_a, qn = adaptive_search(index, Qh, j=0.5, verbose=False,
                                 db_norms=norms)
    out["adaptive_wall_s"] = round(time.perf_counter() - t0, 2)
    out["adaptive_queries"] = nq
    out["adaptive_hits"] = len(hits_a)

    # --- int8-plane exact engine (ann/int_index.py): the serving path for
    # INTEGER sketch dbs — P plain int8 Karatsuba matmuls per chunk (the
    # pairwise sweep's representation) + exact int64/f64 finalize over a
    # pooled candidate set. Measures the device scan (marginal chain) and
    # the full host-finalized path (which adds the D2H per batch)
    # separately.
    from metagenome_vector_sketches_tpu.ann.int_index import (
        IntExactIndex, _int_scan_pool, _host_planes)
    index = None                          # free the bf16 stack first

    @functools.partial(jax.jit, static_argnames=("rows", "dd", "mag"))
    def synth_int_chunk(key, rows, dd, mag):
        return jax.random.randint(key, (rows, dd), -mag, mag + 1, jnp.int32)

    mag = 1200                            # realistic sketch magnitude, L=2
    # larger chunks amortize the per-chunk scan overheads (merge top_k,
    # slab gathers): 262144 measured 3215 q/s vs 2102 at 65536 (N=1M);
    # 524288 OOMs during construction (int32 chunk + planes + stack)
    ICHUNK = min(262144, N)
    ikeys = jax.random.split(jax.random.PRNGKey(5),
                             (N + ICHUNK - 1) // ICHUNK)
    t0 = time.perf_counter()
    ichunks = []
    s = 0
    while s < N:
        rows = min(ICHUNK, N - s)
        ichunks.append((s, synth_int_chunk(ikeys[len(ichunks)], rows, d,
                                           mag)))
        s += rows
    qbase = np.asarray(ichunks[0][1][:B])  # host copy before consumption
    iidx = IntExactIndex.from_device_chunks(ichunks, d)
    out["int8_build_s"] = round(time.perf_counter() - t0, 2)
    out["int8_L"] = iidx.L
    out["int8_stack_bytes"] = int(np.prod(iidx._stack.shape))
    rngq = np.random.default_rng(8)
    qi = (qbase + rngq.integers(-40, 41, size=qbase.shape)).astype(np.int32)
    pool = iidx.pool_for(k)
    qp0 = jnp.asarray(_host_planes(qi, iidx.L))

    # stack/inv_n MUST be explicit args: a jit closure would embed the 6 GB
    # stack as an HLO literal
    @functools.partial(jax.jit, static_argnames=("pool", "rt"))
    def int_seeded(qp, stack, inv_n, seed, pool, rt):
        s_, i_, p_ = _int_scan_pool.__wrapped__(
            qp + (seed * 0).astype(jnp.int8), stack, inv_n,
            N, pool, recall_target=rt)
        return (jnp.sum(s_) + jnp.sum(i_).astype(jnp.float32)
                + jnp.sum(p_).astype(jnp.float32))

    def int_chain(rt):
        def chain(n):
            t0 = time.perf_counter()
            seed = jnp.float32(0)
            for _ in range(n):
                seed = int_seeded(qp0, iidx._stack, iidx._inv_n, seed,
                                  pool, rt)
            float(np.asarray(seed))
            return time.perf_counter() - t0

        return marginal_time(chain, reps=4, rounds=3)

    w_int = int_chain(1.0)
    out["int8_scan_qps_exact"] = round(B / w_int, 1)
    w_inta = int_chain(0.95)
    out["int8_scan_qps_approx95"] = round(B / w_inta, 1)
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        D_int, I_int = iidx.search(qi, k)
        walls.append(time.perf_counter() - t0)
    out["int8_full_qps_exact"] = round(B / float(np.median(walls)), 1)
    out["int8_self_in_topk"] = round(
        float(np.mean([b in set(I_int[b].tolist()) for b in range(B)])), 3)
    iidx.mode = "approx"
    D_a, I_a = iidx.search(qi, k)
    hits = sum(len(set(I_a[b]) & set(I_int[b])) for b in range(B))
    out["int8_approx95_recall_at_k"] = round(hits / (B * k), 4)
    iidx.mode = "exact"

    # adaptive expanding pipeline over the int8 engine (round-4
    # frontier-batched loop, reference jaccard.py:120-174 semantics):
    # the serving headline — measured cold (compiles included) and warm, with the planted-neighbor hit rate
    # recorded next to it
    Qh_i = qi.astype(np.float64) / np.sqrt(d)
    db_norms_i = np.sqrt(iidx.ns / d)
    from metagenome_vector_sketches_tpu.ann import search as _srch
    # batch scaling: the frontier loop's per-round costs (1 pooled-scan
    # dispatch + a 2-scalar/query stats sync) are ~batch-independent, so
    # served q/s grows with the batch until the scan itself dominates —
    # serve-32 is the reference's interactive shape, serve-B the bulk one
    for nq_i in dict.fromkeys((32, min(B, len(qi)))):
        walls_a = []
        for _ in range(3):
            t0 = time.perf_counter()
            hits_i, _ = adaptive_search(iidx, Qh_i[:nq_i], j=0.5,
                                        verbose=False, db_norms=db_norms_i,
                                        queries_int=qi[:nq_i])
            walls_a.append(time.perf_counter() - t0)
        tag = f"int8_adaptive_b{nq_i}"
        out[tag] = {
            "wall_cold_s": round(walls_a[0], 2),
            "wall_warm_s": round(min(walls_a[1:]), 3),
            "qps_warm": round(nq_i / min(walls_a[1:]), 1),
            "hits": len(hits_i),
            "self_found": len({h[0] for h in hits_i if h[1] == h[0]}),
            "stages": {k: (round(v, 1) if isinstance(v, float) else v)
                       for k, v in _srch.LAST_ADAPTIVE_STAGES.items()},
        }
        if nq_i == 32:   # keep the r4-comparable flat fields
            out["int8_adaptive_wall_cold_s"] = out[tag]["wall_cold_s"]
            out["int8_adaptive_wall_warm_s"] = out[tag]["wall_warm_s"]
            out["int8_adaptive_qps_warm"] = out[tag]["qps_warm"]
            out["int8_adaptive_queries"] = nq_i
            out["int8_adaptive_hits"] = out[tag]["hits"]
            out["int8_adaptive_self_found"] = out[tag]["self_found"]

    print(json.dumps(out))


if __name__ == "__main__":
    main()
