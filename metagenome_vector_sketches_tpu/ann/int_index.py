"""Exact cosine top-k over INTEGER sketch vectors via int8 Karatsuba planes.

A serving engine for the jaccard ANN path (reference src/jaccard.py:120-174).
The reference (and our FlatIPIndex parity path) normalizes the integer
sketch vectors to float32 and searches an IndexFlatIP — HIGHEST-precision
float32 matmuls over an 8 GB float32 stack at N=1M x d=2048. This engine
instead reuses the pairwise engine's database representation
(ops/pairwise.py): the integer vectors are decomposed ONCE into
P = L(L+1)/2 int8 Karatsuba planes (6 GB at N=1M, L=2) and each query
batch runs P plain int8 matmuls per chunk at the int8 matmul rate — the
same path as the pairwise sweep.

Exactness model (stronger than FAISS):
  - per-plane partial dots are EXACT int32 (bounded by d*128^2 < 2^31);
  - the device ranks candidates by a float32 weighted combine of the
    partials times 1/|v| — its certified dot error is
    required_slack_abs(L, max_abs, d) * d (ops/pairwise.py), i.e. ~1e-5
    in cosine at sketch scales;
  - the device keeps a top-``pool`` candidate set per query WITH the
    plane partials; the host recombines them into exact int64 dots
    (plane_weights_int) and ranks by float64 cosine
    dot / sqrt(|v|^2 |q|^2), with |.|^2 exact int64 sums.
  So the returned scores are float64-exact cosines and the ranking is
  exact among pooled candidates; a true top-k hit can be displaced only
  when it is within ~2x the f32-combine bound of the pool boundary —
  an error of the same order the reference's float32 FAISS scores carry
  on EVERY hit, without its exact rescue.

Selection modes: ``exact`` pools via jax.lax.top_k; ``approx`` pools via
jax.lax.approx_max_k (recall_target bounds pool misses; pooled hits are
still exact-math rescored).
"""

from __future__ import annotations

import functools
import time

import numpy as np
import jax
import jax.numpy as jnp

from ..ops import pairwise as pw
from ..utils import compilecache
compilecache.ensure()


# per-stage wall split of the LAST IntExactIndex.search() call (the
# pairwise engine's LAST_STAGES pattern), attributing the served wall.
# Keys: prep_ms (host query plane decompose + H2D), dispatch_ms (host time
# to enqueue the scan+pack programs), device_d2h_ms (wall of the ONE
# combined-buffer host read = device scan + transfer; the pure-scan
# marginal is measured separately by bench.py), d2h_bytes, finalize_ms
# (host exact recombine + rank).
LAST_SEARCH_STAGES: dict = {}


@jax.jit
def _pack_pool(i, p):
    """(B, pool) int32 indices + (P, B, pool) int32 partials -> ONE flat
    int32 buffer, so a single D2H transfer moves everything the host
    finalize needs (each transfer carries a fixed latency). The f32
    ranking scores are NOT
    transferred at all — the host reranks from the exact partials."""
    return jnp.concatenate([i.reshape(-1), p.reshape(-1)])


def _inv_norms(ns, C: int, R: int, n: int) -> np.ndarray:
    """(C, R) float32 1/sqrt(|v|^2) ranking weights (0 for zero rows) from
    the exact int64 squared norms of the first n rows; pad rows stay 0."""
    inv = np.zeros((C, R), dtype=np.float32)
    flat = np.sqrt(np.asarray(ns, dtype=np.float64))
    with np.errstate(divide="ignore"):
        iv = np.where(flat > 0, 1.0 / flat, 0.0).astype(np.float32)
    inv.reshape(-1)[:n] = iv
    return inv


def _host_planes(v: np.ndarray, L: int) -> np.ndarray:
    """(n, d) int -> (P, n, d) int8 Karatsuba planes on host (balanced
    limbs + pairwise limb sums; sums fit int8 because digits are in
    [-64, 63])."""
    limbs = pw.decompose_limbs_host(np.asarray(v, dtype=np.int32), L)
    P = pw.num_planes(L)
    if P == L:
        return limbs
    out = np.empty((P,) + limbs.shape[1:], dtype=np.int8)
    out[:L] = limbs
    p = L
    for a in range(L):
        for b in range(a + 1, L):
            out[p] = limbs[a] + limbs[b]
            p += 1
    return out


@functools.partial(jax.jit, donate_argnums=(0,))
def _stack_update(buf, limbs, c):
    """Write one chunk's planes into the (C, P, R, d) int8 stack IN PLACE
    (donated): peak HBM stays stack + one chunk during construction."""
    planes = pw.karatsuba_planes(limbs)
    return jax.lax.dynamic_update_slice(buf, planes[None], (c, 0, 0, 0))


@functools.partial(jax.jit, donate_argnums=(0,), static_argnames=("L",))
def _stack_update_from_ints(buf, chunk, c, L: int):
    """Device-side staging for ALREADY-DEVICE-RESIDENT int32 chunks: write
    the chunk's planes into the (C, P, R, d) stack IN PLACE and return the
    per-plane per-row self-sums sum_d plane_p^2 (exact int32, bounded by
    d*128^2) — the host recombines them with plane_weights_int into exact
    int64 |v|^2, so norms never require int64 (or any extra pass) on
    device."""
    planes = pw.karatsuba_planes(pw.decompose_limbs.__wrapped__(chunk, L))
    p32 = planes.astype(jnp.int32)
    selfs = jnp.sum(p32 * p32, axis=2)                  # (P, R)
    return jax.lax.dynamic_update_slice(
        buf, planes[None], (c, 0, 0, 0)), selfs


def combine_partials_f32(w: np.ndarray, S):
    """float32 weighted combine of (P, ...) exact int32 plane partials,
    summed in plane order as elementwise products (the form of
    ops.pairwise.approx_dot_f32). Written as a contraction, the GPU may run
    it in TF32, whose 10-bit mantissa breaks the certified float32 combine
    bound (module docstring) once partials pass 2^11."""
    out = S[0].astype(jnp.float32) * w[0]
    for p in range(1, S.shape[0]):
        out = out + S[p].astype(jnp.float32) * w[p]
    return out


@functools.partial(jax.jit, static_argnames=("pool", "recall_target",
                                             "selector"))
def _int_scan_pool(q_planes, stack, inv_n, n_total, pool: int,
                   recall_target: float = 1.0, base0=0,
                   selector: str = "topk", bases=None, valid=None):
    """Whole-index candidate pooling as ONE program: lax.scan over the
    (C, P, R, d) plane stack; per chunk P int8 matmuls -> exact int32
    plane partials, f32 weighted combine * 1/|v| ranking scores, top-pool
    selection CARRYING the partials so the host can recombine exactly.

    base0 offsets the emitted global indices (a mesh-sharded caller passes
    its device's first global row, ann/distributed.py). For NON-contiguous
    chunk layouts (per-process row blocks, ann/distributed.py
    from_process_shards) pass explicit per-chunk ``bases`` (C,) global
    first-row ids and ``valid`` (C,) valid-row counts instead; base0 /
    n_total are then ignored.

    Returns (scores (B, pool) f32, indices (B, pool) i32,
             partials (P, B, pool) i32)."""
    C, P, R, d = stack.shape
    B = q_planes.shape[1]
    L = pw.limbs_from_planes(P)
    w = pw.plane_weights(L)
    pool_eff = min(pool, C * R)
    kc = min(pool_eff, R)
    if bases is None:
        bases = base0 + jnp.arange(C, dtype=jnp.int32) * R
        valid = jnp.clip(n_total - bases, 0, R).astype(jnp.int32)
    else:
        assert valid is not None, "explicit bases require explicit valid"
        bases = jnp.asarray(bases, jnp.int32)
        valid = jnp.asarray(valid, jnp.int32)

    # two-stage EXACT per-chunk selection: lax.top_k over the full (B, R)
    # scores is costlier than the rest of the scan. Stage 1 takes per-128-block
    # maxes and the top-kc BLOCKS; stage 2 re-selects within the gathered
    # block slab. Exact: an element outside the chosen blocks is <= its
    # block max < the kc-th block max, and each chosen block contributes
    # >= 1 element >= that bound, so the true top-kc all live in chosen
    # blocks. Sorting the chosen block ids keeps slab order == global
    # order, so tie-breaking matches lax.top_k exactly (lowest index
    # first). The pooled partials then ride the SAME slab (two small
    # block-aligned hops) instead of one scattered gather over the
    # (P, B, R) partials array (~2.2 ms at R=65536).
    nb = R // 128
    two_stage = (selector == "topk" and recall_target >= 1.0
                 and R % 128 == 0 and kc <= nb and kc < R)

    def step(carry, xs):
        best_s, best_i, best_p = carry
        planes_c, inv_c, base, val = xs
        S = jnp.stack([
            jax.lax.dot_general(
                q_planes[p], planes_c[p],
                dimension_numbers=(((1,), (1,)), ((), ())),
                preferred_element_type=jnp.int32)
            for p in range(P)])                       # (P, B, R) exact
        comb = combine_partials_f32(w, S)
        lane = jax.lax.iota(jnp.int32, R)
        ok = lane < val
        # invalid lanes get id -1 so a pad entry can never alias a real
        # row id in the host finalize (uneven per-process shards)
        idx = jnp.where(ok, base + lane, -1)
        score = comb * inv_c[None, :]
        score = jnp.where(ok[None, :], score, -jnp.inf)
        if recall_target < 1.0:
            s1, sel = jax.lax.approx_max_k(score, kc,
                                           recall_target=recall_target,
                                           aggregate_to_topk=True)
            p1 = jnp.take_along_axis(S, sel[None], axis=2)
        elif selector == "partial":
            # ApproxTopK at recall_target=1.0 keeps the full per-partition
            # top-k before the merge — mathematically exact. bench.py
            # A/Bs this against 'topk' WITH an equality check
            # before it is ever trusted for serving.
            s1, sel = jax.lax.approx_max_k(score, kc, recall_target=1.0,
                                           aggregate_to_topk=True)
            p1 = jnp.take_along_axis(S, sel[None], axis=2)
        elif two_stage:
            cb = score.reshape(B, nb, 128)
            bm = jnp.max(cb, axis=2)                  # (B, nb)
            _, bsel = jax.lax.top_k(bm, kc)
            bsel = jnp.sort(bsel, axis=1)             # global tie order
            slab = jnp.take_along_axis(cb, bsel[:, :, None], axis=1)
            s1, fsel = jax.lax.top_k(slab.reshape(B, kc * 128), kc)
            sel = jnp.take_along_axis(bsel, fsel // 128, axis=1) * 128 \
                + fsel % 128
            # partials via the same block slab: a (P, B, kc, 128)
            # block-aligned gather + tiny in-slab gather
            slabS = jnp.take_along_axis(
                S.reshape(P, B, nb, 128), bsel[None, :, :, None], axis=2)
            p1 = jnp.take_along_axis(
                slabS.reshape(P, B, kc * 128), fsel[None], axis=2)
        else:
            s1, sel = jax.lax.top_k(score, kc)
            p1 = jnp.take_along_axis(S, sel[None], axis=2)  # (P, B, kc)
        i1 = idx[sel]
        all_s = jnp.concatenate([best_s, s1], axis=1)
        all_i = jnp.concatenate([best_i, i1], axis=1)
        all_p = jnp.concatenate([best_p, p1], axis=2)
        ns, sel2 = jax.lax.top_k(all_s, pool_eff)
        ni = jnp.take_along_axis(all_i, sel2, axis=1)
        nP = jnp.take_along_axis(all_p, sel2[None], axis=2)
        return (ns, ni, nP), None

    init = (jnp.full((B, pool_eff), -jnp.inf, jnp.float32),
            jnp.full((B, pool_eff), -1, jnp.int32),
            jnp.zeros((P, B, pool_eff), jnp.int32))
    (s, i, p), _ = jax.lax.scan(step, init, (stack, inv_n, bases, valid))
    return s, i, p


def _dbfolder_staging(db_folder: str, chunk_rows: int):
    """Shared host side of db-folder staging: memory-mapped reads, exact
    int64 norms, stale-sidecar trust-but-verify, limb decomposition — with
    a one-deep prefetch thread so disk/decompose overlaps the consumer's
    device work. Returns (n, d, max_abs, L, R, C, ns, iterator); the
    iterator yields (c, limbs (L, R, d) int8) in chunk order, and ``ns``
    (exact int64 |v|^2) fills progressively as chunks are consumed — it is
    complete once the iterator is exhausted."""
    import os
    from ..io.dbfolder import DbFolder
    db = DbFolder(db_folder)
    n, d = db.num_vectors, db.dimension
    vec_dt = np.int16 if db.dtype == "int16" else np.int32
    V = np.memmap(os.path.join(db_folder, "vectors.bin"), dtype=vec_dt,
                  mode="r", shape=(n, d))
    R = int(min(chunk_rows, max(1, n)))
    C = (n + R - 1) // R
    # L from the (possibly sidecar-cached) max component, verified
    # against the data during staging with the SAME shared check as
    # matrix.compute's stagers (so the two verifiers cannot drift)
    from ..matrix.compute import scan_max_abs, _check_stale_max
    max_abs = int(scan_max_abs(db, chunk=R))
    pw.check_exact_dot_range(d, max(1, max_abs))
    L = pw.pick_limbs(max(1, max_abs))
    ns = np.empty(n, dtype=np.int64)

    def prepare(c):
        s, e = c * R, min((c + 1) * R, n)
        block = np.zeros((R, d), dtype=np.int32)
        block[:e - s] = V[s:e]
        _check_stale_max(block[:e - s], max_abs, db)
        b64 = block[:e - s].astype(np.int64)
        ns[s:e] = np.einsum("ij,ij->i", b64, b64)
        return pw.decompose_limbs_host(block, L)

    def chunks():
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(max_workers=1) as tp:
            fut = tp.submit(prepare, 0)
            for c in range(C):
                limbs = fut.result()
                if c + 1 < C:
                    fut = tp.submit(prepare, c + 1)
                yield c, limbs

    return n, d, max_abs, L, R, C, ns, chunks()


class IntExactIndex:
    """Exact-cosine top-k over an integer vector database, int8-plane
    resident on device. Drop-in for FlatIPIndex in the jaccard flow when
    the db folder's INT vectors are available (they always are — the db
    itself is the index; no faiss.index artifact required).

    mode: 'exact' (certified pooling, the default) | 'approx'
    (recall_target-bounded pooling; rescoring stays exact-math)."""

    def __init__(self, vectors: np.ndarray, chunk_rows: int = 262144,
                 mode: str = "exact", recall_target: float = 0.95,
                 pool_margin: int = 64):
        assert mode in ("exact", "approx"), mode
        V = np.asarray(vectors)
        if V.dtype not in (np.int8, np.int16, np.int32):
            raise ValueError("IntExactIndex requires integer vectors; "
                             f"got {V.dtype}")
        self._shape = V.shape
        self.chunk_rows = int(min(chunk_rows, max(1, V.shape[0])))
        self.mode = mode
        self.recall_target = float(recall_target)
        self.pool_margin = int(pool_margin)
        self.selector = "topk"
        self._build_from_host(V)

    # -- construction --------------------------------------------------------
    def _build_from_host(self, V):
        n, d = V.shape
        R = self.chunk_rows
        C = (n + R - 1) // R
        # chunk-wise max/norms: a whole-array int64 einsum would hold two
        # full int64 copies of V transiently (32 GB at N=1M x d=2048)
        max_abs = 0
        for s in range(0, n, R):
            blk = V[s:s + R].astype(np.int64)
            max_abs = max(max_abs, int(np.max(np.abs(blk))) if blk.size
                          else 0)
        pw.check_exact_dot_range(d, max(1, max_abs))
        self.max_abs = max_abs
        self.L = pw.pick_limbs(max(1, max_abs))
        P = pw.num_planes(self.L)
        self.ns = np.empty(n, dtype=np.int64)
        stack = jnp.zeros((C, P, R, d), dtype=jnp.int8)
        for c in range(C):
            s, e = c * R, min((c + 1) * R, n)
            block = np.zeros((R, d), dtype=np.int32)
            block[:e - s] = V[s:e]
            b64 = block[:e - s].astype(np.int64)
            self.ns[s:e] = np.einsum("ij,ij->i", b64, b64)  # exact |v|^2
            limbs = pw.decompose_limbs_host(block, self.L)
            stack = _stack_update(stack, jnp.asarray(limbs), jnp.int32(c))
        self._inv_n = jnp.asarray(_inv_norms(self.ns, C, R, n))
        self._stack = stack

    @classmethod
    def from_dbfolder(cls, db_folder: str, chunk_rows: int = 262144,
                      mode: str = "exact",
                      recall_target: float = 0.95) -> "IntExactIndex":
        """Stage the db folder's vectors.bin straight into the plane stack
        (memory-mapped host side; device peak = stack + one chunk). The
        exact |v|^2 norms are recomputed from the data (int64), so scoring
        does not depend on the float32-reduced vector_norms.txt."""
        assert mode in ("exact", "approx"), mode
        self = cls.__new__(cls)
        self.mode = mode
        self.recall_target = float(recall_target)
        self.pool_margin = 64
        self.selector = "topk"
        n, d, max_abs, L, R, C, ns, chunks = _dbfolder_staging(
            db_folder, chunk_rows)
        self._shape = (n, d)
        self.chunk_rows = R
        self.max_abs = max_abs
        self.L = L
        P = pw.num_planes(L)
        stack = jnp.zeros((C, P, R, d), dtype=jnp.int8)
        for c, limbs in chunks:
            stack = _stack_update(stack, jnp.asarray(limbs), jnp.int32(c))
        self.ns = ns
        self._inv_n = jnp.asarray(_inv_norms(ns, C, R, n))
        self._stack = stack
        return self

    @classmethod
    def from_device_chunks(cls, chunks, d: int, mode: str = "exact",
                           recall_target: float = 0.95) -> "IntExactIndex":
        """Build from ALREADY-DEVICE-RESIDENT int32 chunks
        [(base_row, (rows, d) jnp int32), ...] — the device-side construction
        (benchmarks/ann_scale.py): planes are decomposed on device into the
        donated stack, and exact |v|^2 norms are recovered on host from the
        per-plane self-sums (no int64 on device, no vector D2H). Chunks
        must be uniform and contiguous (base_i == i * R). The chunk list
        is CONSUMED (emptied) so the int32 originals free as staging
        proceeds."""
        assert chunks, "empty chunk list"
        R = int(chunks[0][1].shape[0])
        n = sum(int(c.shape[0]) for _, c in chunks)
        assert all(int(c.shape[0]) == R for _, c in chunks[:-1]) \
            and int(chunks[-1][1].shape[0]) <= R \
            and all(int(b) == i * R for i, (b, _) in enumerate(chunks)), \
            "device chunks must be uniform and contiguous"
        assert mode in ("exact", "approx"), mode
        C = len(chunks)
        max_abs = max(int(jnp.max(jnp.abs(c))) for _, c in chunks)
        pw.check_exact_dot_range(d, max(1, max_abs))
        self = cls.__new__(cls)
        self._shape = (n, d)
        self.chunk_rows = R
        self.mode = mode
        self.recall_target = float(recall_target)
        self.pool_margin = 64
        self.selector = "topk"
        self.max_abs = max_abs
        self.L = pw.pick_limbs(max(1, max_abs))
        P = pw.num_planes(self.L)
        stack = jnp.zeros((C, P, R, d), dtype=jnp.int8)
        selfs = np.empty((C, P, R), dtype=np.int64)
        c = 0
        while chunks:
            _, chunk = chunks.pop(0)
            if int(chunk.shape[0]) < R:
                chunk = jnp.concatenate(
                    [chunk, jnp.zeros((R - int(chunk.shape[0]), d),
                                      jnp.int32)])
            stack, sf = _stack_update_from_ints(stack, chunk,
                                                jnp.int32(c), self.L)
            selfs[c] = np.asarray(sf)
            del chunk
            c += 1
        self._stack = stack
        w = pw.plane_weights_int(self.L)
        ns_all = np.einsum("p,cpr->cr", w, selfs).reshape(-1)  # exact
        self.ns = ns_all[:n]
        self._inv_n = jnp.asarray(_inv_norms(self.ns, C, R, n))
        return self

    @property
    def ntotal(self) -> int:
        return self._shape[0]

    @property
    def d(self) -> int:
        return self._shape[1]

    # -- search --------------------------------------------------------------
    def pool_for(self, k: int) -> int:
        """Candidate pool size: k plus a margin absorbing the f32 device
        ranking error at the selection boundary (the error is ~1e-5 in
        cosine at sketch scales — see module docstring — so a thin
        absolute margin suffices; it grows k/8 for very deep adaptive
        levels where boundary density rises)."""
        return min(k + max(self.pool_margin, k >> 3), max(1, self.ntotal))

    def _pool(self, qp, pool: int, rt: float):
        """Device candidate pooling (overridden by the mesh-sharded
        DistributedIntExactIndex)."""
        return _int_scan_pool(qp, self._stack, self._inv_n,
                              self.ntotal, pool, recall_target=rt,
                              selector=self.selector)

    def validate_queries(self, queries: np.ndarray) -> None:
        """Shared query-range check (search() and the device-resident
        adaptive frontier in ann/search.py): integer dtype, components
        within the L-limb range this index was decomposed for."""
        Q = np.asarray(queries)
        if Q.dtype not in (np.int8, np.int16, np.int32, np.int64):
            raise ValueError("IntExactIndex takes integer query "
                             f"vectors; got {Q.dtype}")
        qmax = int(np.max(np.abs(Q.astype(np.int64)))) if Q.size else 0
        if not pw._limbs_ok(max(1, qmax), self.L):
            raise ValueError(
                f"query |component| {qmax} exceeds the L={self.L} limb "
                f"range this index was built for (db max_abs="
                f"{self.max_abs}); use the FlatIPIndex f32 path")

    def search(self, queries: np.ndarray, k: int):
        """queries: (B, d) INTEGER vectors (projected query sketches).
        -> (D (B, k) float32 exact-float64 cosines, I (B, k) int32);
        missing slots are (0, -1) like FAISS when k > ntotal."""
        Q = np.asarray(queries)
        B = Q.shape[0]
        if self.ntotal == 0:
            if Q.dtype not in (np.int8, np.int16, np.int32, np.int64):
                raise ValueError("IntExactIndex takes integer query "
                                 f"vectors; got {Q.dtype}")
            return (np.zeros((B, k), np.float32),
                    np.full((B, k), -1, np.int32))
        self.validate_queries(Q)
        k_eff = min(k, self.ntotal)
        pool = self.pool_for(k_eff)
        LAST_SEARCH_STAGES.clear()
        t0 = time.perf_counter()
        qp = jnp.asarray(_host_planes(Q.astype(np.int32), self.L))
        LAST_SEARCH_STAGES["prep_ms"] = (time.perf_counter() - t0) * 1e3
        rt = self.recall_target if self.mode == "approx" else 1.0
        t0 = time.perf_counter()
        s, i, p = self._pool(qp, pool, rt)
        buf = _pack_pool(i, p)
        LAST_SEARCH_STAGES["dispatch_ms"] = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        flat = np.asarray(buf)                         # the ONE host read
        LAST_SEARCH_STAGES["device_d2h_ms"] = \
            (time.perf_counter() - t0) * 1e3
        LAST_SEARCH_STAGES["d2h_bytes"] = flat.nbytes
        t0 = time.perf_counter()
        W = i.shape[1]                                 # pool_eff
        Pn = pw.num_planes(self.L)
        idx = flat[:B * W].reshape(B, W)               # (B, pool)
        parts = flat[B * W:].reshape(Pn, B, W).astype(np.int64)
        w = pw.plane_weights_int(self.L)
        dots = np.einsum("p,pbk->bk", w, parts)        # exact int64
        qns = np.einsum("ij,ij->i", Q.astype(np.int64), Q.astype(np.int64))
        denom = np.sqrt(self.ns[np.maximum(idx, 0)].astype(np.float64)
                        * qns[:, None].astype(np.float64))
        with np.errstate(divide="ignore", invalid="ignore"):
            score = np.where(denom > 0, dots / np.maximum(denom, 1e-300),
                             0.0)
        score = np.where(idx >= 0, score, -np.inf)
        # ONE batched lexsort (query-major, then exact score desc, then
        # lowest index — the FAISS tie order): invalid entries carry -inf
        # so each row's valid hits form a PREFIX of its order
        rows = np.repeat(np.arange(B), W)
        order = np.lexsort((idx.ravel(), -score.ravel(), rows))
        cols = (order % W).reshape(B, W)[:, :k_eff]
        top_i = np.take_along_axis(idx, cols, axis=1)
        top_s = np.take_along_axis(score, cols, axis=1)
        valid = top_i >= 0
        D = np.zeros((B, k), dtype=np.float32)
        I = np.full((B, k), -1, dtype=np.int32)
        I[:, :k_eff] = np.where(valid, top_i, -1)
        D[:, :k_eff] = np.where(valid, top_s, 0.0).astype(np.float32)
        LAST_SEARCH_STAGES["finalize_ms"] = (time.perf_counter() - t0) * 1e3
        return D, I
