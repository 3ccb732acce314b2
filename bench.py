"""Benchmark driver: prints ONE JSON line with the headline metric.

Headline: pairwise sims/sec/GPU at d=2048 — the reference's flagship compute
(blocked integer GEMM + retention threshold), run here as int8 Karatsuba
plane matmuls with the threshold fused into the epilogue
(ops.pairwise.sweep_counts), timed over a full synthetic all-vs-all sweep.
vs_baseline compares against the reference's own hot loop measured on a CPU
(BASELINE_MEASURED.json). It needs a GPU and fails without one.

Also measured (reported in "extras"): sketch projection throughput
(hashes/sec and vectors/sec, device path) and flat-IP top-k query throughput.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np


# Dense int8 tensor-core peak (ops/s, multiply+add = 2 ops) by JAX
# device_kind, from NVIDIA's H100 data sheet: SXM 1,979 TOP/s, PCIe
# 1,513 TOP/s (both at the full power limit). A kind missing here is an
# error, not a default.
_PEAK_INT8_OPS = {
    "NVIDIA H100 80GB HBM3": 1979e12,
    "NVIDIA H100 PCIe": 1513e12,
}


def _peak_int8_ops():
    import jax
    kind = jax.devices()[0].device_kind
    if kind not in _PEAK_INT8_OPS:
        raise KeyError(f"no int8 peak for device kind {kind!r}: add it to "
                       "_PEAK_INT8_OPS with its source")
    return _PEAK_INT8_OPS[kind], kind


def _mfu_fields(ops: float, seconds: float, amortized_seconds: float):
    """MFU bookkeeping for one kernel measurement.

    `seconds` is the marginal per-iteration estimate (noisy — it is a
    DIFFERENCE of two walls);
    `amortized_seconds` is wall/n of the longest chain, an upper bound on the
    true per-iteration time (includes one dispatch amortized over n), so the
    throughput it implies is a certified LOWER bound. If the marginal claims
    more than 100% of chip peak it is a measurement fault: fall back to the
    amortized number and flag it.
    """
    peak, _ = _peak_int8_ops()
    out = {}
    mfu = ops / seconds / peak
    mfu_lb = ops / amortized_seconds / peak
    out["mfu_lower_bound"] = round(mfu_lb, 4)
    if mfu > 1.0:
        out["mfu"] = round(min(mfu_lb, 1.0), 4)
        out["mfu_marginal_rejected"] = round(mfu, 4)
        out["mfu_note"] = ("marginal timing exceeded chip peak "
                           "(measurement fault); amortized wall used")
        return amortized_seconds, out
    out["mfu"] = round(mfu, 4)
    return seconds, out


def bench_pairwise(N=8192, d=2048, tile=2048, max_abs=1500, reps=10):
    """Headline: the counts sweep (the engine's phase-1 hot loop, one jitted
    lax.scan over the whole tile grid). Measured as the MARGINAL time per
    sweep over a chain of data-dependent sweeps ending in one host read, so
    dispatch/transfer latency doesn't pollute the device-throughput number;
    the end-to-end wall time is reported too."""
    import jax
    import jax.numpy as jnp
    from metagenome_vector_sketches_tpu.ops import pairwise as pw

    rng = np.random.default_rng(0)
    V = rng.integers(-max_abs, max_abs + 1, size=(N, d)).astype(np.int32)
    norms_sq = (np.einsum("ij,ij->i", V.astype(np.float64), V.astype(np.float64))
                / d).astype(np.float32)
    L = pw.pick_limbs(max_abs)
    limbs = pw.decompose_planes(jnp.asarray(V), L)
    limbs.block_until_ready()
    thr = jnp.asarray(norms_sq)
    nt = N // tile
    coords = jnp.asarray(np.array([(r, c) for r in range(nt) for c in range(nt)],
                                  dtype=np.int32))

    import functools

    @functools.partial(jax.jit, static_argnames=("tile",))
    def sweep_seeded(limbs, thr, coords, seed, tile):
        # data dependence via seed forces sequential real execution of the chain
        return pw.sweep_counts_impl(limbs, thr, coords, tile) + seed * 0

    def chained(step, shape, n):
        t0 = time.perf_counter()
        acc = jnp.zeros(shape, jnp.int32)
        for _ in range(n):
            acc = step(acc)
        total = int(np.asarray(acc).sum())
        return time.perf_counter() - t0, total

    def measure(step, shape, rounds=5, chain_reps=None):
        """Median-of-`rounds` marginal sweep time, with the drift band
        (min/median/max of the per-round marginals) and the amortized
        per-iteration wall (best n-chain / n — an upper bound on true
        per-iteration time, so a certified throughput lower bound). The
        marginal is a DIFFERENCE of two walls, so taking the minimum would
        select rounds where the 1-iteration chain hit a latency spike (it
        can even go negative); the median is robust against spikes in
        either term. chain_reps lengthens the chains (halving marginal
        noise per doubling — used for the ~5 ms i16 sweeps whose roll-to-
        roll medians drifted +-15% at reps=10)."""
        n_reps = chain_reps or reps
        chained(step, shape, 1)  # warm-up / compile
        margins, d1s, dns, total = [], [], [], 0
        for _ in range(rounds):
            d1, _ = chained(step, shape, 1)
            dn, total = chained(step, shape, n_reps)
            margins.append((dn - d1) / (n_reps - 1))
            d1s.append(d1)
            dns.append(dn)
        good = [m for m in margins if m > 0] or margins
        band = {"min_ms": round(min(good) * 1e3, 3),
                "median_ms": round(float(np.median(good)) * 1e3, 3),
                "max_ms": round(max(good) * 1e3, 3)}
        amortized = min(dns) / n_reps
        return float(np.median(good)), float(np.median(d1s)), total, \
            band, amortized

    per_sweep, d1, total, band, amort = measure(
        lambda acc: sweep_seeded(limbs, thr, coords, acc, tile=tile), (nt * nt,))
    P = pw.num_planes(L)
    sweep_ops = 2.0 * P * float(N) * N * d     # P int8 plane matmuls, 2 ops/MAC
    per_sweep, mfu = _mfu_fields(sweep_ops, per_sweep, amort)
    extras = {"N": N, "d": d, "tile": tile, "L": L,
              "xla_sweep_ms": round(per_sweep * 1e3, 3),
              "xla_sweep_band": band,
              "xla_mfu": mfu,
              "wall_one_sweep_ms": round(d1 * 1e3, 1),
              "candidates": total}

    pairs = float(N) * N
    extras["sweep_ms"] = round(per_sweep * 1e3, 3)
    extras["mfu"] = round(sweep_ops / per_sweep / _peak_int8_ops()[0], 4)

    # secondary: the int16-dtype sweep (L=3 -> 6 plane matmuls); full N so
    # the per-sweep time is long enough for a stable marginal measurement
    N16 = N
    V16 = rng.integers(-32768, 32768, size=(N16, d)).astype(np.int32)
    n16 = (np.einsum("ij,ij->i", V16.astype(np.float64),
                     V16.astype(np.float64)) / d).astype(np.float32)
    L16 = pw.pick_limbs(32767)
    p16 = pw.decompose_planes(jnp.asarray(V16), L16)
    p16.block_until_ready()
    t16 = jnp.asarray(n16)
    nt16 = N16 // tile
    c16 = jnp.asarray(np.array([(r, c) for r in range(nt16)
                                for c in range(nt16)], dtype=np.int32))
    s16, _, _, b16, a16 = measure(
        lambda acc: sweep_seeded(p16, t16, c16, acc, tile=tile),
        (nt16 * nt16,), chain_reps=25)
    ops16 = 2.0 * pw.num_planes(L16) * float(N16) * N16 * d
    s16, mfu16 = _mfu_fields(ops16, s16, a16)
    extras["i16_sweep_ms"] = round(s16 * 1e3, 3)
    extras["i16_sweep_band"] = b16
    extras["i16_mfu"] = mfu16
    extras["i16_pairs_per_sec"] = round(float(N16) * N16 / s16, 1)

    return pairs / per_sweep, extras


# THE canonical marginal-timing harness (shared with the scale
# benchmarks; the drift bands live there)
from metagenome_vector_sketches_tpu.utils.profiling import (  # noqa: E402
    marginal_time as _marginal,
)


def bench_projection(B=64, H=4096, d=2048):
    import jax.numpy as jnp
    from metagenome_vector_sketches_tpu.ops.projection import project_device_batch
    from metagenome_vector_sketches_tpu.ops.splitmix import split_u64

    rng = np.random.default_rng(1)
    hashes = rng.integers(0, 1 << 64, size=(B, H), dtype=np.uint64)
    counts = np.full(B, H, dtype=np.int32)
    hi, lo = split_u64(hashes)
    hi, lo = jnp.asarray(hi), jnp.asarray(lo)
    cj0 = jnp.asarray(counts)

    import functools
    import jax

    @functools.partial(jax.jit, static_argnames=("d",))
    def proj_seeded(hi, lo, cj, seed, d):
        v = project_device_batch.__wrapped__(hi, lo, cj, d)
        return jnp.sum(v) + seed * 0  # full reduce: nothing dead-code-eliminated

    def chain(n):
        t0 = time.perf_counter()
        seed = jnp.int32(0)
        for _ in range(n):
            seed = proj_seeded(hi, lo, cj0, seed, d)
        np.asarray(seed)
        return time.perf_counter() - t0

    dt, band = _marginal(chain, band=True)
    return {"hashes_per_sec": B * H / dt, "vectors_per_sec": B / dt,
            "B": B, "H": H, "d": d, "band": band}


def bench_topk(N=65536, d=2048, B=256, k=50):
    import jax
    import jax.numpy as jnp
    from metagenome_vector_sketches_tpu.ann.flat_index import (
        _chunk_topk, normalize_l2)

    rng = np.random.default_rng(2)
    V = jnp.asarray(normalize_l2(rng.normal(size=(N, d)).astype(np.float32)))
    Q0 = jnp.asarray(normalize_l2(rng.normal(size=(B, d)).astype(np.float32)))

    import functools

    @functools.partial(jax.jit, static_argnames=("k", "recall"))
    def topk_seeded(q, V, seed, k, recall):
        best_d = jnp.full((q.shape[0], k), -jnp.inf, jnp.float32)
        best_i = jnp.full((q.shape[0], k), -1, jnp.int32)
        D, I = _chunk_topk.__wrapped__(q, V, 0, best_d, best_i, k,
                                       recall_target=recall)
        return jnp.sum(D) + jnp.sum(I).astype(jnp.float32) + seed * 0

    def chain_for(recall):
        def chain(n):
            t0 = time.perf_counter()
            seed = jnp.float32(0)
            for _ in range(n):
                seed = topk_seeded(Q0, V, seed, k, recall)
            np.asarray(seed)
            return time.perf_counter() - t0
        return chain

    dt, band = _marginal(chain_for(1.0), band=True)
    dt_approx = _marginal(chain_for(0.95))
    res = {"queries_per_sec": B / dt,
           "queries_per_sec_recall95": B / dt_approx,
           "N": N, "B": B, "k": k, "band": band}

    # int8-plane exact engine (ann/int_index.py) on the same workload:
    # P int8 matmuls per chunk + pooled exact finalize. Scan qps is the
    # device-resident serving number (marginal chain); full qps includes
    # the pool D2H + float64 host finalize.
    from metagenome_vector_sketches_tpu.ann.int_index import (
        IntExactIndex, _int_scan_pool, _host_planes)
    Vi = rng.integers(-1200, 1201, size=(N, d)).astype(np.int32)
    iidx = IntExactIndex(Vi, chunk_rows=min(65536, N))
    Qi = (Vi[:B] + rng.integers(-40, 41, size=(B, d))).astype(np.int32)
    pool = iidx.pool_for(k)
    qp0 = jnp.asarray(_host_planes(Qi, iidx.L))

    # stack passed as an ARG (a jit closure would embed it as an HLO
    # literal, see DESIGN.md §7)
    @functools.partial(jax.jit, static_argnames=("pool",))
    def int_seeded(qp, stack, inv_n, seed, pool):
        s_, i_, p_ = _int_scan_pool.__wrapped__(
            qp + (seed * 0).astype(jnp.int8), stack, inv_n, N, pool)
        return (jnp.sum(s_) + jnp.sum(i_).astype(jnp.float32)
                + jnp.sum(p_).astype(jnp.float32))

    def ichain(n):
        t0 = time.perf_counter()
        seed = jnp.float32(0)
        for _ in range(n):
            seed = int_seeded(qp0, iidx._stack, iidx._inv_n, seed, pool)
        float(np.asarray(seed))
        return time.perf_counter() - t0

    dt_int = _marginal(ichain)
    res["int8_scan_qps"] = B / dt_int

    # A/B the PartialReduce-based exact selector (approx_max_k at
    # recall_target=1.0) against lax.top_k: must be RESULT-EQUAL (both
    # exact) — record its speed only when equality holds on this backend
    s_t, i_t, p_t = _int_scan_pool(qp0, iidx._stack, iidx._inv_n, N, pool)
    s_p, i_p, p_p = _int_scan_pool(qp0, iidx._stack, iidx._inv_n, N, pool,
                                   selector="partial")
    if np.array_equal(np.asarray(i_t), np.asarray(i_p)):
        iidx.selector = "partial"

        @functools.partial(jax.jit, static_argnames=("pool",))
        def int_seeded_p(qp, stack, inv_n, seed, pool):
            s_, i_, p_ = _int_scan_pool.__wrapped__(
                qp + (seed * 0).astype(jnp.int8), stack, inv_n, N, pool,
                selector="partial")
            return (jnp.sum(s_) + jnp.sum(i_).astype(jnp.float32)
                    + jnp.sum(p_).astype(jnp.float32))

        def pchain(n):
            t0 = time.perf_counter()
            seed = jnp.float32(0)
            for _ in range(n):
                seed = int_seeded_p(qp0, iidx._stack, iidx._inv_n, seed,
                                    pool)
            float(np.asarray(seed))
            return time.perf_counter() - t0

        res["int8_scan_qps_partial_exact"] = B / _marginal(pchain)
        res["partial_selector_equal"] = True
        iidx.selector = "topk"
    else:
        res["partial_selector_equal"] = False
    from metagenome_vector_sketches_tpu.ann import int_index as _ii
    walls, stages = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        D_int, I_int = iidx.search(Qi, k)
        walls.append(time.perf_counter() - t0)
        stages.append(dict(_ii.LAST_SEARCH_STAGES))
    med = int(np.argsort(walls)[len(walls) // 2])
    res["int8_full_qps"] = B / float(np.median(walls))
    # per-stage split of the served wall: device_d2h_ms is the ONE packed
    # host read (scan + transfer of B*pool*(1+P) int32s)
    res["int8_search_stages"] = {
        key: (round(val, 2) if key.endswith("_ms") else val)
        for key, val in stages[med].items()}
    res["int8_search_stages"]["scan_ms_marginal"] = round(dt_int * 1e3, 2)
    res["int8_self_in_topk"] = float(
        np.mean([b in set(I_int[b].tolist()) for b in range(B)]))
    return res


def bench_e2e_pairwise(N=65536, d=2048, n_clusters=32768, tile=2048, seed=4):
    """Honest END-TO-END shard production: synthetic
    clustered db -> full compute_pairwise_shard (staging + sweep +
    extraction + exact host finalize + shard write), with the per-stage
    split from matrix.compute.LAST_STAGES.
    """
    import shutil
    import tempfile
    from metagenome_vector_sketches_tpu.io.dbfolder import DbFolder
    from metagenome_vector_sketches_tpu.matrix import compute as mc

    # clustered magnitude-realistic int32 sketch-like vectors, host-made
    # (projection throughput is measured separately; this block times the
    # pairwise engine). ~2 members/cluster -> ~3e5 surviving pairs. The
    # generator is shared with benchmarks/scale_test.py.
    from benchmarks.scale_test import synth_vectors_host
    V, _ = synth_vectors_host(N, d, n_clusters=n_clusters, seed=seed)
    tmp = tempfile.mkdtemp(prefix="mvs_e2e_")
    walls = []
    try:
        db = DbFolder.write(os.path.join(tmp, "db"),
                            [f"A{i:07d}" for i in range(N)], V, d)
        # best-of-2; the db stays staged on device across trials, like a
        # multi-shard production run
        st_cold = None
        for trial in range(2):
            out_dir = os.path.join(tmp, f"m{trial}")
            t0 = time.perf_counter()
            mc.compute_pairwise_shard(db.path, out_dir,
                                      tile_rows=tile, verbose=False)
            walls.append(time.perf_counter() - t0)
            if trial == 0:
                st_cold = dict(mc.LAST_STAGES)
            if walls[-1] == min(walls):
                st = dict(mc.LAST_STAGES)
        wall = min(walls)
    finally:
        mc.clear_device_cache()
        shutil.rmtree(tmp, ignore_errors=True)
    out = {"N": N, "d": d, "tile": tile,
           "mode": st.get("mode"),
           "e2e_wall_s": round(wall, 2),
           "e2e_walls_s": [round(w, 2) for w in walls],
           "pairs_per_sec_e2e": round(float(N) * N / wall, 1),
           "candidates": int(st.get("candidates", 0)),
           "pairs_written": int(st.get("pairs_written", 0))}
    for k in ("stage_ms", "sweep_ms", "extract_ms", "finalize_ms",
              "write_ms", "stage_decompose_ms", "stage_h2d_ms"):
        out[k] = round(float(st.get(k, 0.0)), 1)
    # cold-start attribution: the FIRST trial's split explains the cold
    # wall — staging decompose vs H2D vs the first fused dispatch (which
    # carries the program compiles)
    def _dispatch_fields(stt, dst):
        walls = stt.get("dispatch_walls_ms") or []
        if walls:
            dst["dispatch_first_ms"] = walls[0]
            dst["dispatch_rest_median_ms"] = \
                round(float(np.median(walls[1:])), 1) if len(walls) > 1 \
                else None
            dst["dispatch_count_recorded"] = len(walls)

    _dispatch_fields(st, out)
    if st_cold is not None:
        cold = {k: round(float(st_cold.get(k, 0.0)), 1)
                for k in ("stage_ms", "stage_decompose_ms", "stage_h2d_ms",
                          "extract_ms", "finalize_ms", "write_ms")}
        _dispatch_fields(st_cold, cold)
        cold["wall_s"] = round(walls[0], 2)
        out["cold"] = cold
    return out


def bench_matrix_reads(N=20000, neighbors=12, B=5000, seed=6):
    """Host-side matrix top-k read throughput (the reference's query serving
    path): batched native row decode over a synthetic N-row shard."""
    import shutil
    import tempfile
    from metagenome_vector_sketches_tpu.matrix import writer
    from metagenome_vector_sketches_tpu.matrix.reader import MatrixReader

    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(N), neighbors)
    cols = (rows + np.tile(np.arange(neighbors), N) * 7) % N
    key = np.unique(rows * N + cols)
    rows, cols = key // N, key % N
    vals = rng.integers(1, 10**9, size=len(rows)).astype(np.int64)
    ns = rng.uniform(1e3, 1e5, size=N)
    tmp = tempfile.mkdtemp(prefix="mvs_read_")
    try:
        writer.write_shard(os.path.join(tmp, "shard_0"), rows, cols, vals,
                           ns, 2048)
        reader = MatrixReader(tmp)
        qrows = rng.integers(0, N, size=B).tolist()
        reader.load_neighbors_for_rows(qrows[:16], N)  # warm mmap/index
        best = 1e9
        for _ in range(3):
            t0 = time.perf_counter()
            reader.load_neighbors_for_rows(qrows, N)
            best = min(best, time.perf_counter() - t0)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"queries_per_sec": round(B / best, 1), "N": N, "B": B,
            "neighbors_per_row": neighbors}


def bench_conformance():
    """On-device correctness certification: the toy db's decoded shard
    triples must equal the exact float64 oracle on the GPU (the tests run
    on the CPU, so without this block no bench artifact certifies the
    device's arithmetic)."""
    import shutil
    import tempfile
    from metagenome_vector_sketches_tpu.io.dbfolder import DbFolder
    from metagenome_vector_sketches_tpu.matrix import compute as mc
    from metagenome_vector_sketches_tpu.matrix.reader import MatrixReader
    from metagenome_vector_sketches_tpu.matrix.writer import quantize_jaccard

    here = os.path.dirname(os.path.abspath(__file__))
    toy = os.path.join(here, "tests", "fixtures", "ref_toy", "toy_db_256")
    out = {}
    tmp = tempfile.mkdtemp(prefix="mvs_conf_")
    try:
        db = DbFolder(toy)
        V = db.load_vectors().astype(np.int32)
        _, norms = db.names_and_norms()
        ns = norms * norms
        n, d = V.shape
        mc.compute_pairwise_shard(toy, os.path.join(tmp, "m"),
                                  tile_rows=64, verbose=False)
        er, ec, ev = mc.compute_pairwise_oracle(V, ns, d)
        eq = quantize_jaccard(ev, er, ec, ns, d)
        rr, cc, qq = MatrixReader(os.path.join(tmp, "m")).decode_all_triples(n)
        out["toy_oracle"] = set(zip(rr.tolist(), cc.tolist(), qq.tolist())) \
            == set(zip(er.tolist(), ec.tolist(), eq.tolist()))
        out["toy_pairs"] = int(len(rr))
    finally:
        mc.clear_device_cache()
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def bench_compile_cache():
    """Cross-process compile-cache demonstration: the reference deploys
    one process per shard (pairwise_comp_optimized.cpp:938-941), so what
    matters is whether the SECOND process's first dispatch hits the
    persistent cache. Two fresh subprocesses run the pairwise engine on the
    same (deliberately non-production) program shape against one EMPTY
    cache directory: proc1 is the cold control by construction, proc2
    should hit. This process already holds the card, so each child gets
    XLA_PYTHON_CLIENT_MEM_FRACTION=CHILD_MEM_FRACTION of it (reported
    beside the numbers)."""
    import shutil
    import subprocess
    import tempfile
    here = os.path.dirname(os.path.abspath(__file__))
    probe = os.path.join(here, "tools", "compile_cache_probe.py")
    N, d, tile = 1536, 1408, 512
    out = {"N": N, "d": d, "tile": tile,
           "child_mem_fraction": CHILD_MEM_FRACTION}
    cache_dir = tempfile.mkdtemp(prefix="mvs_cc_cache_")
    env = dict(os.environ, JAX_COMPILATION_CACHE_DIR=cache_dir,
               XLA_PYTHON_CLIENT_MEM_FRACTION=str(CHILD_MEM_FRACTION))
    try:
        for tag in ("proc1_cold", "proc2_cached"):
            p = subprocess.run(
                [sys.executable, probe, str(N), str(d), str(tile)],
                timeout=900, capture_output=True, text=True, env=env)
            line = p.stdout.strip().splitlines()[-1] if p.stdout.strip() \
                else ""
            if p.returncode != 0 or not line.startswith("{"):
                raise RuntimeError(f"{tag} failed: {p.stderr[-400:]}")
            out[tag] = json.loads(line)
    finally:
        shutil.rmtree(cache_dir, ignore_errors=True)
    f1 = out["proc1_cold"]["dispatch_first_ms"]
    f2 = out["proc2_cached"]["dispatch_first_ms"]
    out["speedup_vs_cold"] = round(f1 / f2, 2)
    # first dispatch also pays H2D + real execution, so the cached
    # floor is not ~0; "hit" = the compile component clearly vanished
    out["cross_process_hit"] = bool(f2 < 0.5 * f1)
    return out


# share of the card each compile-cache child may reserve next to this
# process's own reservation
CHILD_MEM_FRACTION = 0.08


def main():
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "BASELINE_MEASURED.json")) as f:
        base = json.load(f)
    baseline_pps = base["pairwise_d2048"]["pairs_per_sec"]
    baseline_proj = base["projection_d2048"]["hashes_per_sec"]

    import jax
    if jax.default_backend() != "gpu":
        raise SystemExit(f"bench.py needs a GPU; JAX's backend is "
                         f"{jax.default_backend()!r}")
    pps, pair_extras = bench_pairwise()
    proj = bench_projection()
    topk = bench_topk()
    e2e = bench_e2e_pairwise()
    # the production-scale shard: quarter-million rows, 6.9e10 pairs
    e2e["N262k"] = bench_e2e_pairwise(N=262144, n_clusters=131072)

    dev = jax.devices()[0]
    result = {
        "metric": "pairwise_sims_per_sec_per_chip_d2048",
        "value": round(pps, 1),
        "unit": "pairs/s",
        "vs_baseline": round(pps / baseline_pps, 2),
        "extras": {
            "device": {"platform": dev.platform, "kind": dev.device_kind,
                       "count": len(jax.devices())},
            "conformance": bench_conformance(),
            "pairwise": pair_extras,
            "projection": {**{k: round(v, 1) if isinstance(v, float) else v
                              for k, v in proj.items()},
                           "vs_baseline": round(proj["hashes_per_sec"] / baseline_proj, 2)},
            "flat_ip_topk": {k: round(v, 1) if isinstance(v, float) else v
                             for k, v in topk.items()},
            "e2e_pairwise": e2e,
            "matrix_reads": bench_matrix_reads(),
            # production row density: server matrix rows carry hundreds
            # of neighbors (README.md:111 scale)
            "matrix_reads_dense": bench_matrix_reads(N=20000,
                                                     neighbors=400,
                                                     B=2000),
            "compile_cache": bench_compile_cache(),
        },
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
