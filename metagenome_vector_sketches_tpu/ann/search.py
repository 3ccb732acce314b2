"""Adaptive expanding ANN search (reference jaccard.py:63-224).

Query hash sets are projected with the same seeded kernel as the database,
scaled by 1/sqrt(d) and L2-normalized; the flat index is searched with an
expanding k = 50 * 3^i schedule: queries whose k-th inner product is still
above the threshold 2j/(1+j) are re-searched at a deeper level (skipping a
level when the margin exceeds 0.05 — the reference's estimate heuristic),
capped at 50*3^19. Hits are rescored to exact-form Jaccard
ip*|q||n| / (|n|^2 + |q|^2 - ip*|q||n|), filtered > j, sorted descending.
"""

from __future__ import annotations

import functools
import os
import time

import numpy as np
import jax
import jax.numpy as jnp

from ..io.dbfolder import DbFolder
from ..io.hashes import parse_query_hashes_file
from .flat_index import FlatIPIndex, normalize_l2

INITIAL_NB_SEARCHES = 50
MAX_LEVELS = 20  # 50 * 3^19 hard cap (jaccard.py:129)

# per-stage wall split of the LAST adaptive_search call (the pairwise
# engine's LAST_STAGES pattern): rounds, prep_ms (query staging/upload),
# dispatch_ms (program enqueue), stats_ms (the per-round 2-scalar-per-query
# signal D2H), collect_ms (final-level hit compaction D2H + exact host
# recombine), host_ms (python frontier bookkeeping).
LAST_ADAPTIVE_STAGES: dict = {}


@jax.jit
def _level_stats(D, min_ip, nb_row):
    """Per-query expansion signals of one frontier round — the ONLY
    per-round host read for continuing queries: (any score above min_ip
    within the query's OWN nb prefix, the query's nb-th score). nb_row is
    per-query because one round batches queries at DIFFERENT expansion
    levels (the shared scan runs at the max nb; a larger-k search returns
    the same ordered prefix, so each query's own-level signals are exact).
    Packed into ONE (2, B) float32 array so the round costs a single D2H
    round trip."""
    k = D.shape[1]
    in_range = jnp.arange(k, dtype=jnp.int32)[None, :] < nb_row[:, None]
    any_above = jnp.any((D > min_ip) & in_range, axis=1)
    kth = jnp.take_along_axis(
        D, jnp.maximum(nb_row[:, None] - 1, 0), axis=1)[:, 0]
    return jnp.stack([any_above.astype(jnp.float32), kth])


@functools.partial(jax.jit, static_argnames=("cap",))
def _compact_hits(D, I, qn, nn_all, j, nb_row, cap: int, Pp=None):
    """Conservative device-side hit filter + compaction for queries at their
    FINAL expansion level: keep (row, idx, ip) where the float32 Jaccard
    estimate clears j with slack (the host refilters exactly in float64; the
    slack only prevents false negatives). Only ranks < the query's own nb
    count (rows come from a shared max-nb scan).

    Returns ONE packed int32 buffer
    [count, q(cap), idx(cap), ip_bits(cap), partials(P*cap)...] so the
    collect sync is a single D2H round trip; ip rides as a float32
    bitcast. Retry with a larger
    cap if buf[0] > cap.

    Pp (optional): (P, B, k) exact int32 plane partials riding the same
    ranks (the int8 engine's device-resident frontier) — compacted
    alongside, so the host can recombine the emitted hits' ips EXACTLY
    (float64) instead of trusting the f32 device ranking scores."""
    B, k = D.shape
    nn = nn_all[jnp.maximum(I, 0)]
    qn_b = qn[:, None]
    ipqn = D * qn_b * nn
    jac = ipqn / jnp.maximum(nn * nn + qn_b * qn_b - ipqn, 1e-30)
    in_range = jnp.arange(k, dtype=jnp.int32)[None, :] < nb_row[:, None]
    keep = (I >= 0) & in_range \
        & (jac > j * np.float32(1.0 - 1e-3) - np.float32(1e-6))
    flat = keep.reshape(-1)
    count = jnp.sum(flat.astype(jnp.int32))
    pos = jnp.nonzero(flat, size=cap, fill_value=-1)[0]
    safe = jnp.maximum(pos, 0)
    out_q = jnp.where(pos >= 0, (safe // k).astype(jnp.int32), -1)
    out_i = jnp.where(pos >= 0, I.reshape(-1)[safe], -1)
    out_ip = jnp.where(pos >= 0, D.reshape(-1)[safe], np.float32(0))
    ip_bits = jax.lax.bitcast_convert_type(out_ip, jnp.int32)
    parts = [count[None], out_q, out_i, ip_bits]
    if Pp is not None:
        out_p = jnp.where(pos[None, :] >= 0, Pp[:, safe // k, safe % k], 0)
        parts.append(out_p.reshape(-1))
    return jnp.concatenate(parts)


@jax.jit
def _gather_rows(qp_all, qsel):
    """(P, B_all, d) query planes -> the round's (P, B_pad, d) batch."""
    return qp_all[:, qsel, :]


@jax.jit
def _scale_rows(s, invq):
    """Device pool scores (combined dot * 1/|v|) -> f32 cosines."""
    return s * invq[:, None]


def project_queries(hash_sets, dimension: int):
    """Hash sets -> (int32 (n, d) projected vectors, float64 copy scaled
    by 1/sqrt(d)) — the reference's query-vector rule (jaccard.py:96-118:
    standalone_projection output / sqrt(d)); the unscaled integer form
    feeds the int8-plane exact engine."""
    from ..io.ingest import project_hash_lines
    q_int = project_hash_lines(list(hash_sets), dimension).astype(np.int32)
    return q_int, q_int.astype(np.float64) / np.sqrt(dimension)


def adaptive_search(index, queries_f64: np.ndarray, j: float,
                    verbose: bool = True, db_norms=None, queries_int=None):
    """Reference expansion semantics (jaccard.py:120-174), device-state
    execution: per level only (any-above, k-th-score) scalars per query come
    to host; each query's FINAL-level results are filtered + compacted on
    device (conservative float32 Jaccard estimate) so device->host traffic
    is ~the true hit count, not B x nb.

    -> (hits [(query_idx, db_idx, ip_f32)...] in (query, rank) order,
        query_norms (B,) float32).

    queries_int: the UNSCALED integer query vectors; passing them (with an
    ann.int_index.IntExactIndex) routes each level through the int8-plane
    exact engine, DEVICE-RESIDENT across rounds (round 5): the query
    planes upload once, every round runs the pooled scan + level stats on
    device, and the only per-round D2H is 2 scalars per query (the
    expansion signals) plus each FINAL-level query's compacted hits with
    their exact int32 plane partials — the host recombines those into
    float64-exact cosines. Round 4 routed every round through
    index.search(): a (B, nb*(1+P)) int32 pool D2H + host finalize + a
    (B, nb) re-upload per round, which dominated the served wall.
    Expansion/filter semantics are unchanged. Candidate-boundary note:
    the nb-prefix slicing rides the device's f32 combined-score ranking
    (certified error ~1e-5 cosine, ops/pairwise.required_slack_abs), so a
    neighbor whose exact score sits within that error of the nb-th score
    can fall just outside the prefix — the same f32-ranked-candidate
    semantics as the reference, whose expansion consumes FAISS's f32
    scores directly (jaccard.py:127-170). IntExactIndex.search() keeps
    its wider pool_for(k) margin for the serving API; EMITTED hits here
    still carry float64-exact recombined scores either way.
    """
    LAST_ADAPTIVE_STAGES.clear()
    LAST_ADAPTIVE_STAGES.update(rounds=0, prep_ms=0.0, dispatch_ms=0.0,
                                stats_ms=0.0, collect_ms=0.0, host_ms=0.0)
    t_all = time.perf_counter()
    t0 = t_all
    queries = queries_f64.astype(np.float32)
    query_norms = np.linalg.norm(queries, axis=1)
    queries = normalize_l2(queries)
    min_ip = np.float32(2 * j / (1 + j))
    int_dev = queries_int is not None and hasattr(index, "_pool") \
        and index.ntotal > 0
    if int_dev:
        from ..ops import pairwise as pw
        from .int_index import _host_planes
        Qi = np.ascontiguousarray(queries_int, dtype=np.int32)
        index.validate_queries(Qi)
        qp_all = jnp.asarray(_host_planes(Qi, index.L))   # ONE upload
        qns_int = np.einsum("ij,ij->i", Qi.astype(np.int64),
                            Qi.astype(np.int64))          # exact |q|^2
        with np.errstate(divide="ignore"):
            invq_all = np.where(
                qns_int > 0, 1.0 / np.sqrt(qns_int.astype(np.float64)),
                0.0).astype(np.float32)
        rt_int = index.recall_target if index.mode == "approx" else 1.0
        w_int = pw.plane_weights_int(index.L)
    LAST_ADAPTIVE_STAGES["prep_ms"] = (time.perf_counter() - t0) * 1e3
    if db_norms is None:
        # squared-norm recovery from the normalized index rows is not
        # possible; callers should pass vector_norms.txt values. Fallback:
        # keep every I>=0 candidate (filter happens exactly on host anyway).
        nn_all = None
    else:
        nn_all = jnp.asarray(np.asarray(db_norms, dtype=np.float32))

    hits: list[tuple[int, int, float]] = []

    def _pow2(x: int) -> int:
        return 1 << max(0, (x - 1)).bit_length()

    def _exact_ips(gq, out_i, parts):
        """Host recombine of compacted (P, c) int32 plane partials into
        float64-exact cosines (dot / sqrt(|v|^2 |q|^2), both norms exact
        int64) — the same math as IntExactIndex.search's finalize."""
        dots = np.einsum("p,pc->c", w_int, parts.astype(np.int64))
        denom = np.sqrt(index.ns[np.maximum(out_i, 0)].astype(np.float64)
                        * qns_int[gq].astype(np.float64))
        with np.errstate(divide="ignore", invalid="ignore"):
            return np.where(denom > 0, dots / np.maximum(denom, 1e-300),
                            0.0)

    def collect(D_dev, I_dev, qidx, nb_rows, Pp=None):
        """Device-compact final hits for the rows of qidx (rows padded to a
        power of two with -inf scores so program shapes stay stable).
        nb_rows: each query's OWN result width within the shared scan.
        Pp: (P, rows, k) exact int32 plane partials riding the same ranks
        (the int8 device-resident route) — emitted hits then carry
        float64-exact cosines recombined on host instead of the f32
        device scores."""
        if nn_all is None:
            # no db norms: keep every valid candidate (exact host refilter
            # follows); vectorized collect, still (query, rank) order
            D = np.asarray(D_dev)
            I = np.asarray(I_dev)
            rows, ranks = np.nonzero(
                (I >= 0) & (np.arange(I.shape[1])[None, :]
                            < np.asarray(nb_rows)[:, None]))
            qidx_arr = np.asarray(qidx)
            gq = qidx_arr[rows]
            if Pp is not None:
                parts = np.asarray(Pp)[:, rows, ranks]       # (P, c)
                ips = _exact_ips(gq, I[rows, ranks], parts)
            else:
                ips = D[rows, ranks].astype(float)
            hits.extend(zip(gq.tolist(), I[rows, ranks].tolist(),
                            ips.tolist()))
            return
        R, k = D_dev.shape
        R_pad = _pow2(R)
        if R_pad != R:
            D_dev = jnp.concatenate(
                [D_dev, jnp.full((R_pad - R, k), -jnp.inf, jnp.float32)])
            I_dev = jnp.concatenate(
                [I_dev, jnp.full((R_pad - R, k), -1, jnp.int32)])
            if Pp is not None:
                Pp = jnp.concatenate(
                    [Pp, jnp.zeros((Pp.shape[0], R_pad - R, k), Pp.dtype)],
                    axis=1)
        qn_rows = np.ones(R_pad, dtype=np.float32)
        qn_rows[:R] = query_norms[np.asarray(qidx)].astype(np.float32)
        nb_pad = np.zeros(R_pad, dtype=np.int32)
        nb_pad[:R] = np.asarray(nb_rows, dtype=np.int32)
        cap = 4096
        while True:
            buf = np.asarray(_compact_hits(          # the ONE host read
                D_dev, I_dev, jnp.asarray(qn_rows), nn_all,
                np.float32(j), jnp.asarray(nb_pad), cap, Pp))
            count = int(buf[0])
            if count <= cap:
                break
            cap = 1 << (count - 1).bit_length()
        out_q = buf[1:1 + count]
        out_i = buf[1 + cap:1 + cap + count]
        gq = np.asarray(qidx)[out_q]
        if Pp is not None:
            parts = buf[1 + 3 * cap:].reshape(-1, cap)[:, :count]  # (P, c)
            ips = _exact_ips(gq, out_i, parts)
        else:
            ips = buf[1 + 2 * cap:1 + 2 * cap + count] \
                .view(np.float32).astype(float)
        hits.extend(zip(gq.tolist(), out_i.tolist(), ips.tolist()))

    # FRONTIER loop (round 4): one shared full-DB scan per round serves
    # every still-expanding query AT ITS OWN LEVEL — the scan runs at the
    # round's max nb, and a larger-k search returns the same ordered prefix,
    # so per-query signals/results sliced at that query's nb are exactly
    # what its own-level search would return. A level-ordered loop would
    # re-scan the full database once per DISTINCT level; at N=1M each scan
    # is HBM-bound and B-independent, so batching levels into one scan
    # removes whole scans.
    # Expansion semantics (incl. the skip-a-level heuristic) are unchanged
    # from the reference, jaccard.py:120-174.
    level_of = np.zeros(len(queries), dtype=np.int64)
    frontier = list(range(len(queries)))
    while frontier:
        qidx = np.asarray(frontier)
        levels = level_of[qidx]
        nbs = INITIAL_NB_SEARCHES * np.power(3, levels)
        nb_eff = np.minimum(nbs, index.ntotal).astype(np.int64)
        k = int(nb_eff.max())
        if verbose:
            print(f"Searching {sorted(set(nbs.tolist()))} : ", qidx)
        # pad the round batch to a power of two: data-dependent batch sizes
        # would otherwise compile a fresh program per distinct size
        B = len(qidx)
        B_pad = _pow2(B)
        Pp_round = None
        LAST_ADAPTIVE_STAGES["rounds"] += 1
        t0 = time.perf_counter()
        if int_dev:
            # device-resident route: gather the round's rows from the
            # staged query planes ON DEVICE, pool at the round's max nb
            # (k is already clamped to ntotal), keep scores/indices/plane
            # partials on device — no per-round pool D2H or re-upload
            qsel = np.zeros(B_pad, dtype=np.int32)        # pads scan q0
            qsel[:B] = qidx
            s_dev, I_dev, Pp_round = index._pool(
                _gather_rows(qp_all, jnp.asarray(qsel)), int(k), rt_int)
            D_dev = _scale_rows(s_dev, jnp.asarray(invq_all[qsel]))
        elif queries_int is not None:
            # no device pool on this index type: per-round host search
            qb = np.zeros((B_pad, queries_int.shape[1]), dtype=np.int32)
            qb[:B] = queries_int[qidx]
            D_np, I_np = index.search(qb, k)
            D_dev, I_dev = jnp.asarray(D_np), jnp.asarray(I_np)
        else:
            qbatch = np.zeros((B_pad, queries.shape[1]), dtype=np.float32)
            qbatch[:B] = queries[qidx]
            D_dev, I_dev = index.search_device(jnp.asarray(qbatch), k)
        nb_pad = np.ones(B_pad, dtype=np.int32)
        nb_pad[:B] = nb_eff
        sig = _level_stats(D_dev, min_ip, jnp.asarray(nb_pad))
        LAST_ADAPTIVE_STAGES["dispatch_ms"] += \
            (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        # the round's ONLY mandatory host sync: ONE packed (2, B) read
        sig_h = np.asarray(sig)
        any_above = sig_h[0, :B] > 0
        kth = sig_h[1, :B]
        LAST_ADAPTIVE_STAGES["stats_ms"] += (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        stopped_rows = []
        frontier = []
        for row, q in enumerate(qidx):
            level = int(levels[row])
            deeper = bool(any_above[row]) and kth[row] > min_ip \
                and nbs[row] < index.ntotal  # full-db result cannot expand
            if deeper:
                # estimate how much deeper to go (jaccard.py:162-167)
                if kth[row] - 0.05 > min_ip and level <= MAX_LEVELS - 3:
                    level_of[q] = level + 2
                    frontier.append(int(q))
                elif level <= MAX_LEVELS - 2:
                    level_of[q] = level + 1
                    frontier.append(int(q))
                else:
                    stopped_rows.append(row)
            else:
                stopped_rows.append(row)
        LAST_ADAPTIVE_STAGES["host_ms"] += (time.perf_counter() - t0) * 1e3
        if stopped_rows:
            t0 = time.perf_counter()
            rows = np.asarray(stopped_rows)
            collect(D_dev[rows], I_dev[rows], qidx[rows], nb_eff[rows],
                    None if Pp_round is None else Pp_round[:, rows, :])
            LAST_ADAPTIVE_STAGES["collect_ms"] += \
                (time.perf_counter() - t0) * 1e3
    LAST_ADAPTIVE_STAGES["total_ms"] = (time.perf_counter() - t_all) * 1e3
    return hits, query_norms


def rescore(hits, query_norms: np.ndarray, names: list[str],
            norms: np.ndarray, j: float, verbose: bool = True):
    """Exact-form float64 Jaccard rescoring + filter + sort
    (jaccard.py:197-224). hits: [(query_idx, db_idx, ip), ...] in
    (query, rank) order. Returns [(query_idx, neighbor_id, jaccard), ...]."""
    by_query: dict[int, list] = {}
    for q, idx, ip in hits:
        by_query.setdefault(q, []).append((idx, ip))
    out = []
    for i in range(len(query_norms)):
        qn = float(query_norms[i])
        if qn == 0:
            continue
        results = []
        for idx, ip in by_query.get(i, ()):
            nid = names[idx]
            nn = float(norms[idx])
            ip = float(ip)
            jac = ip * qn * nn / (nn ** 2 + qn ** 2 - ip * qn * nn)
            if jac > j:
                results.append((nid, jac, ip, nn, qn))
        results.sort(key=lambda x: x[1], reverse=True)
        if verbose:
            print(f"Query {i}:")
        for rank, (nid, jac, ip, nn, qn_) in enumerate(results):
            if verbose:
                print(f"  Neighbor {rank}: {nid} (jaccard: {jac:.4f}), "
                      f"inner_product: {ip:.4f} {nn} {qn_}")
            out.append((i, nid, jac))
    return out


# the canonical --mesh_devices resolution lives in parallel.mesh (shared
# with the pairwise CLI)
from ..parallel.mesh import serving_mesh as _serving_mesh  # noqa: E402


# one-slot device-resident index cache: repeated search_index calls in one
# process (library users, validation loops) re-use the staged/uploaded
# index instead of re-staging it per call — mirrors the pairwise engine's
# residency cache (matrix/compute._RESIDENT; staging a 1M-row db costs
# tens of seconds). One slot bounds HBM: a different key evicts.
_INDEX_CACHE: dict = {}


def clear_index_cache() -> None:
    _INDEX_CACHE.clear()


def _cached_index(key, build):
    if _INDEX_CACHE.get("key") == key:
        return _INDEX_CACHE["value"]
    _INDEX_CACHE.clear()
    value = build()
    _INDEX_CACHE["key"] = key
    _INDEX_CACHE["value"] = value
    return value


def _artifact_stat(path: str):
    st = os.stat(path)
    return (os.path.abspath(path), st.st_mtime_ns, st.st_size)


def search_index(index_folder: str, query_file: str, j: float,
                 verbose: bool = True, recall_target: float = 1.0,
                 engine: str = "f32", mesh_devices: int = 1):
    """Full search pipeline over a db folder with a built faiss.index
    (reference search_index, jaccard.py:63-224). recall_target < 1.0 opts
    into the ~2x-faster approximate per-chunk top-k (no reference
    counterpart; rescoring stays exact).

    engine: 'f32' (FAISS-parity FlatIPIndex over the faiss.index artifact)
    | 'int8' (int8-plane exact engine staged straight from the db folder's
    integer vectors — no faiss.index needed, float64-exact cosines)
    | 'int8_approx' (same engine, approx_max_k pooling at recall_target).

    mesh_devices != 1 serves every adaptive level mesh-sharded (extension:
    rows/chunks scattered over the devices, candidate pools merged across
    them — ann/distributed.py); results are identical to single-device."""
    db = DbFolder(index_folder)
    d = db.dimension
    sample_names, hash_sets = parse_query_hashes_file(query_file)
    q_int, queries = project_queries(hash_sets, d)
    names, norms = db.names_and_norms()
    mesh = _serving_mesh(mesh_devices)
    if engine in ("int8", "int8_approx"):
        from .int_index import IntExactIndex
        rt = recall_target if recall_target < 1.0 else 0.95
        # --recall_target < 1.0 opts the int8 engine into approx pooling
        # exactly like it opts the f32 engine into approx_max_k (the flag
        # promises the faster path regardless of engine spelling)
        approx = engine == "int8_approx" or recall_target < 1.0
        mode = "approx" if approx else "exact"
        key = (_artifact_stat(os.path.join(index_folder, "vectors.bin")),
               "int8", mode, rt, mesh)
        if mesh is not None:
            # stage straight into the sharded layout: wrapping a
            # single-device index would transiently hold ~2x the stack on
            # one chip (see DistributedIntExactIndex.from_dbfolder)
            from .distributed import DistributedIntExactIndex
            index = _cached_index(key, lambda: (
                DistributedIntExactIndex.from_dbfolder(
                    index_folder, mesh=mesh, mode=mode, recall_target=rt)))
        else:
            index = _cached_index(key, lambda: (
                IntExactIndex.from_dbfolder(index_folder, mode=mode,
                                            recall_target=rt)))
        hits, query_norms = adaptive_search(index, queries, j, verbose,
                                            db_norms=norms,
                                            queries_int=q_int)
    else:
        fpath = os.path.join(index_folder, "faiss.index")
        key = (_artifact_stat(fpath), "f32", mesh)
        if mesh is not None:
            from .distributed import DistributedFlatIPIndex
            index = _cached_index(key, lambda: (
                DistributedFlatIPIndex.from_flat(FlatIPIndex.load(fpath),
                                                 mesh=mesh)))
        else:
            index = _cached_index(key, lambda: FlatIPIndex.load(fpath))
        # recall_target is a per-call knob, not part of the staged state
        index.recall_target = recall_target
        hits, query_norms = adaptive_search(index, queries, j, verbose,
                                            db_norms=norms)
    return rescore(hits, query_norms, names, norms, j, verbose)
