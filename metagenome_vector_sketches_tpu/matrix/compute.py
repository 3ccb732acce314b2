"""The pairwise compute engine: all-vs-all thresholded similarity on the
accelerator.

Replaces the reference's chunked CPU loop (pairwise_comp_optimized.cpp:949-982).
The default (fused) engine runs ONE device program per chunk of tiles:
L(L+1)/2 int8 plane matmuls, the float32 combine + retention threshold,
survivor compaction and the exact per-candidate plane partials
(ops.pairwise.sweep_extract_fused_ij). The two-phase engine keeps the
older split: a counts sweep over the whole tile grid
(ops.pairwise.sweep_counts), then hot-tile extraction into flat indices
(sparse tiles) or packed bitmaps (dense tiles).

Exact finalization: candidate dots are exact int64 (recombined from plane
partials, or recomputed on device or with host float64 BLAS, integer-exact
below 2^53), then the float64/int64 retention and quantization reproduce
both the int32 integer-division and the int16 float-division semantics
(SURVEY.md §2.4), and the shard folder is written in the active format.

The --num_shards/--shard_idx job-array contract is preserved as the unit of
checkpointing/restart. A streaming fallback covers databases whose limb
decomposition exceeds the device memory budget.

With a mesh (parallel.engine.MeshSweepOps) BOTH phases run tile-data-parallel
over all devices — planes replicated, tile coordinates sharded under
shard_map — so a single shard folder is produced by every device of the
mesh, not one.
"""

from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import jax.numpy as jnp

from ..io.dbfolder import DbFolder
from ..ops import pairwise as pw
from ..utils.log import log
from . import writer


# per-shard stage timing of the LAST compute_pairwise_shard call (staging,
# sweep, extraction, exact host finalize, shard write — the honest
# end-to-end split the reference prints as one "Total computation time",
# pairwise_comp_optimized.cpp:993-996). Read by bench.py's e2e block.
LAST_STAGES: dict = {}


def _reset_stages():
    LAST_STAGES.clear()
    LAST_STAGES.update(stage_ms=0.0, sweep_ms=0.0, extract_ms=0.0,
                       finalize_ms=0.0, write_ms=0.0, candidates=0,
                       # candidates = device-extracted/D2H candidate volume;
                       # emitted additionally counts host-side mirror twins
                       # of the triangle grid (keep the bench's
                       # candidates stat meaning extraction traffic)
                       emitted=0,
                       pairs_written=0,
                       # cold-start attribution:
                       # stage_ms further splits into host limb decompose
                       # vs H2D upload; dispatch_walls_ms records the wall
                       # of each fused-chunk dispatch (the FIRST carries
                       # the program compiles, later ones are the steady
                       # state)
                       stage_decompose_ms=0.0, stage_h2d_ms=0.0,
                       dispatch_walls_ms=[])


_MAX_DISPATCH_WALLS = 50


def _note_dispatch_wall(t0: float) -> None:
    walls = LAST_STAGES.get("dispatch_walls_ms")
    if walls is not None and len(walls) < _MAX_DISPATCH_WALLS:
        walls.append(round((time.perf_counter() - t0) * 1e3, 1))


def _acc(key: str, t0: float) -> None:
    if LAST_STAGES:
        LAST_STAGES[key] += (time.perf_counter() - t0) * 1e3


def _next_pow2(x: int) -> int:
    p = 1
    while p < x:
        p *= 2
    return p


def _max_tiles_per_batch(tile: int) -> int:
    """Largest pow2 tile count per extraction batch such that the packed
    candidate index t*tile^2 + local stays within int32 (ops.pairwise
    compact_indices asserts this bound; bit-level fallback path)."""
    k = _next_pow2((2**31 - 1) // (tile * tile) + 1) // 2
    return max(1, k)


def _max_words_per_batch(tile: int) -> int:
    """Same bound for the word-granularity path: packed index is
    t*(tile^2/32) + word, so 32x more tiles fit per batch — fewer, larger
    extraction dispatches."""
    wpt = max(1, (tile * tile) // 32)
    k = _next_pow2((2**31 - 1) // wpt + 1) // 2
    return max(1, k)


def scan_max_abs(db: DbFolder, chunk: int = 8192) -> int:
    """Global max |component| (fixes the limb count statically for the whole
    run). Dbs built by this framework persist it at sketch time in
    max_component.txt (the dimension.txt/dtype.txt file-config pattern,
    project_everything.cpp:306-320), so a multi-shard job array does zero
    extra vectors.bin passes; foreign dbs fall back to one streaming scan."""
    cached = db.max_component()
    if cached is not None:
        return cached
    n = db.total_vectors_from_bin()
    m = 0
    for s in range(0, n, chunk):
        block = db.load_vectors(s, min(s + chunk, n))
        if block.size:
            m = max(m, int(np.max(np.abs(block.astype(np.int64)))))
    return m


def shard_is_complete(output_folder: str, shard_idx: int) -> bool:
    """A shard is complete when its neighbor_start.bin exists (written last
    by the writer) — the unit of checkpoint/restart, like the reference's
    re-run-the-failed-shard recovery model (SURVEY.md §5)."""
    return os.path.exists(os.path.join(output_folder, f"shard_{shard_idx}",
                                       "neighbor_start.bin"))


def compute_pairwise_shard(db_folder: str, output_folder: str,
                           num_shards: int = 1, shard_idx: int = 0,
                           tile_rows: int = 2048, tile_cols: int = 2048,
                           device_budget_bytes: int | None = None,
                           resume: bool = False,
                           verbose: bool = True,
                           mesh=None, finalize: str = "device",
                           engine: str = "fused",
                           gate: bool = False) -> str:
    """Compute one shard of the all-vs-all matrix and write its folder.

    Returns the shard folder path. tile_rows is the square tile edge of both
    paths (tile_cols is accepted for backward compatibility and ignored —
    the streaming path sizes its column window from the memory budget).
    Default 2048: extraction carries a fixed per-hot-tile compaction cost,
    so fewer/larger tiles win at production N. With resume=True, an
    already-complete shard folder is left untouched.

    device_budget_bytes: the int8 planes stay resident on the device when
    they fit it, else the streaming engine runs. Default: the device's
    allocator limit less utils.devmem.HEADROOM_BYTES (8 GiB on the CPU).

    With mesh (a jax.sharding.Mesh over >1 devices), the WHOLE engine —
    counts sweep, hot-tile extraction, sparse compaction — runs
    tile-data-parallel over the mesh (parallel.engine.MeshSweepOps): planes
    replicated, tile coordinates sharded, so one shard folder is produced by
    every chip instead of one. Host finalize + writing stay per-process.

    finalize (two-phase engine only): 'device' (default) recomputes exact
    candidate dots on device from the resident int8 limbs (O(K) host work,
    ~4+2L(L+1) B/candidate D2H); 'host' recomputes them with float64 BLAS
    from the host-resident vectors (4 B/candidate D2H, O(K*d) host
    FLOPs). Both are exact. The streaming fallback always finalizes from
    the vectors memmap.

    engine: 'fused' (default) runs the device-resident path as ONE
    single-pass program per tile chunk — sweep, hierarchical compaction,
    and exact finalize partials fused (ops.pairwise.sweep_extract_fused),
    chunks pipelined so host finalize overlaps device compute; the
    finalize flag is then irrelevant (exact dots are combined from
    in-kernel partials). 'two_phase' keeps the round-2 counts-sweep +
    extraction + separate-finalize engine.

    gate (fused engine only): skip selection + partials on candidate-free
    tiles via an HLO conditional (ops.pairwise.sweep_extract_fused_ij).
    For GENUINELY SPARSE tile grids (most tiles empty — tiny/disjoint
    clusters, very high thresholds); at production density essentially
    every tile is hot, so the cond only adds overhead, hence off by
    default.
    """
    assert finalize in ("host", "device"), finalize
    if device_budget_bytes is None:
        from ..utils.devmem import device_budget
        device_budget_bytes = device_budget(8 << 30)
    # reset BEFORE any early return: a multi-shard loop reading
    # LAST_STAGES after a skipped/empty shard must see zeros, not the
    # previous shard's timings
    _reset_stages()
    if resume and shard_is_complete(output_folder, shard_idx):
        if verbose:
            log(f"Shard {shard_idx} already complete, skipping (resume)")
        return os.path.join(output_folder, f"shard_{shard_idx}")
    ops = None
    if mesh is not None and int(mesh.devices.size) > 1:
        from ..parallel.engine import MeshSweepOps
        ops = MeshSweepOps(mesh)
    db = DbFolder(db_folder)
    d = db.dimension
    dtype = db.dtype
    _, norms = db.names_and_norms()
    norms_sq = norms * norms  # float64, text round-tripped — reference :900

    total = db.total_vectors_from_bin()
    rows_per_shard = (total + num_shards - 1) // num_shards
    begin_row = shard_idx * rows_per_shard
    end_row = min(begin_row + rows_per_shard, total)
    if verbose:
        log(f"Shard {shard_idx} processing rows {begin_row} to {end_row} "
            f"of {total} (d={d}, dtype={dtype})")

    max_abs = scan_max_abs(db)
    # loud up-front rejection: past this bound every exact int64 dot path
    # (fused combine, device finalize, host finalize) would wrap silently
    pw.check_exact_dot_range(d, max(1, max_abs))
    L = pw.pick_limbs(max(1, max_abs))
    exact_filter = pw.exact_filter_int16 if dtype == "int16" else pw.exact_filter_int32

    if begin_row >= end_row:
        # shard beyond the row space (num_shards > N): empty-but-valid folder
        shard_folder = os.path.join(output_folder, f"shard_{shard_idx}")
        writer.write_shard(shard_folder, *_empty(), norms_sq, d)
        return shard_folder

    t0 = time.perf_counter()
    tile = tile_rows
    npad = ((total + tile - 1) // tile) * tile
    plane_bytes = pw.num_planes(L) * npad * d
    if plane_bytes <= device_budget_bytes:
        rows, cols, vals = _compute_device_resident(
            db, norms_sq, total, begin_row, end_row, tile, L, d,
            exact_filter, verbose, max_abs, ops, finalize, engine, gate)
    else:
        rows, cols, vals = _compute_streaming(
            db, norms_sq, total, begin_row, end_row, tile_rows, tile_cols,
            L, d, exact_filter, device_budget_bytes, max_abs, ops, engine,
            gate)

    if verbose:
        dt = (time.perf_counter() - t0) * 1000
        log(f"Total computation time: {dt:.0f} ms ({len(rows)} surviving pairs)")

    shard_folder = os.path.join(output_folder, f"shard_{shard_idx}")
    tw = time.perf_counter()
    writer.write_shard(shard_folder, rows, cols, vals, norms_sq, d)
    _acc("write_ms", tw)
    LAST_STAGES["pairs_written"] = len(rows)
    LAST_STAGES["total_ms"] = (time.perf_counter() - t0) * 1e3
    return shard_folder


def _empty():
    e = np.empty(0, dtype=np.int64)
    return e, e.copy(), e.copy()


def _concat(parts):
    if not parts:
        return _empty()
    return (np.concatenate([p[0] for p in parts]),
            np.concatenate([p[1] for p in parts]),
            np.concatenate([p[2] for p in parts]))


# one-slot device-residency cache: a multi-shard run in one process (the
# multihost runbook path loops this host's shards) re-uses the uploaded +
# plane-decomposed database instead of re-staging it per shard
_RESIDENT: dict = {}

# staging granularity: ~bytes of int8 limbs per H2D chunk (tests shrink it
# to exercise multi-chunk staging on toy databases)
STAGE_CHUNK_BYTES = 256 << 20


def clear_device_cache() -> None:
    _RESIDENT.clear()


def _check_stale_max(block, max_abs, db) -> int:
    """Trust-but-verify the (possibly sidecar-cached) max component against
    a block of data actually loaded — a stale max_component.txt surviving an
    mtime tie (coarse-mtime filesystems) would silently wrap the int8 limb
    decomposition and corrupt every similarity. Shared by the resident and
    streaming stagers so the two paths cannot drift."""
    if block.size == 0:
        return 0
    # two reductions instead of abs(int64(...)) — the temporaries tripled
    # each staging chunk's memory traffic (r5); python ints cannot wrap
    true_max = max(int(block.max()), -int(block.min()))
    if true_max > max_abs:
        raise ValueError(
            f"max_component.txt ({max_abs}) is stale: vectors.bin holds "
            f"|component| up to {true_max}. Delete "
            f"{os.path.join(db.path, 'max_component.txt')} or rebuild "
            "the db folder.")
    return true_max


def _stage_database(db, norms_sq, total, tile, L, d, max_abs, ops=None):
    vec_path = os.path.join(db.path, "vectors.bin")
    norm_path = os.path.join(db.path, "vector_norms.txt")
    key = (os.path.abspath(vec_path),
           os.path.getmtime(vec_path), os.path.getsize(vec_path),
           os.path.getmtime(norm_path), os.path.getsize(norm_path),
           total, tile, L, d, max_abs, None if ops is None else ops.mesh)
    if _RESIDENT.get("key") == key:
        return _RESIDENT["value"]
    npad = ((total + tile - 1) // tile) * tile
    # V stays a HOST MEMORY-MAP (the exact host-finalize path gathers rows
    # from it); the device sees only the int8 planes, built chunk-by-chunk
    # with in-place (donated) updates so peak HBM is planes + one chunk.
    # Uploading the full int32 array next to its planes would take
    # 8.6 GB + 6.4 GB at N=1M x 2048.
    vec_dt = np.int16 if db.dtype == "int16" else np.int32
    V = np.memmap(vec_path, dtype=vec_dt, mode="r", shape=(total, d))
    P = pw.num_planes(L)
    planes = jnp.zeros((P, npad, d), dtype=jnp.int8)  # pad rows stay zero
    chunk = max(tile, (STAGE_CHUNK_BYTES // max(1, L * d)) // tile * tile)
    true_max = 0
    # limb decomposition placement: the HOST path uploads L int8 B/element
    # (best when host-to-device bandwidth is the bottleneck); the DEVICE
    # path uploads the raw int32 (4 B/element) and decomposes on the
    # device (best where PCIe moves GB/s and the single-core numpy
    # decompose would dominate staging). "auto" decides from the FIRST
    # chunk's measured H2D rate (> 500 MB/s => device).
    mode = os.environ.get("MVS_STAGE_DECOMPOSE", "auto")
    for s in range(0, total, chunk):
        e = min(s + chunk, total)
        t0 = time.perf_counter()
        # one copy: asarray(...).astype(int32) made TWO 2 GB passes for
        # int32 memmaps (r5)
        block = np.asarray(V[s:e], dtype=np.int32)
        true_max = max(true_max, _check_stale_max(block, max_abs, db))
        if mode == "device":
            _acc("stage_decompose_ms", t0)
            t0 = time.perf_counter()
            block_dev = jnp.asarray(block)
            jb = getattr(block_dev, "block_until_ready", None)
            if jb:
                jb()          # honest H2D attribution (one RT per chunk)
            h2d_bytes = block.nbytes
            _acc("stage_h2d_ms", t0)
            t0 = time.perf_counter()
            limbs_dev = pw.decompose_limbs_device(block_dev, L)
            _acc("stage_decompose_ms", t0)
        else:
            # upload int8 limbs (L B/element) instead of int32 (4 B/el)
            limbs = pw.decompose_limbs_host(block, L)
            _acc("stage_decompose_ms", t0)
            t0 = time.perf_counter()
            limbs_dev = jnp.asarray(limbs)
            jb = getattr(limbs_dev, "block_until_ready", None)
            if jb:
                jb()          # honest H2D attribution (one RT per chunk)
            h2d_bytes = limbs.nbytes
            _acc("stage_h2d_ms", t0)
        if mode == "auto":
            rate = h2d_bytes / max(1e-9, LAST_STAGES.get("stage_h2d_ms",
                                                         1.0) / 1e3)
            mode = "device" if rate > 500e6 else "host"
        LAST_STAGES["stage_decompose_mode"] = mode
        planes = pw.planes_update(planes, limbs_dev, jnp.int32(s))
    thr = np.full(npad, np.float32(1e30), dtype=np.float32)
    # signed slack adjustment (ops.pairwise.threshold_adjust): widens when
    # the certified float32 combine error exceeds the fixed SLACK_ABS
    # (extreme int16-range components — no false-negative pair vs the
    # exact re-filter), TIGHTENS toward the certified requirement for
    # small-norm databases where a fixed 16 would pass a constant fraction
    # of all pairs to the exact finalize (r5)
    adj = pw.threshold_adjust(L, max_abs, d)
    thr[:total] = (norms_sq + adj).astype(np.float32)
    thr_dev = jnp.asarray(thr)
    if ops is not None:
        planes, thr_dev = ops.replicate(planes, thr_dev)
    value = (V, planes, thr_dev)
    _RESIDENT.clear()
    _RESIDENT["key"] = key
    _RESIDENT["value"] = value
    return value


def _compute_device_resident(db, norms_sq, total, begin_row, end_row, tile,
                             L, d, exact_filter, verbose, max_abs, ops=None,
                             finalize: str = "host", engine: str = "fused",
                             gate: bool = False):
    if engine == "fused" and (tile * tile) % 32 == 0:
        return _compute_device_resident_fused(
            db, norms_sq, total, begin_row, end_row, tile, L, d,
            exact_filter, verbose, max_abs, ops, gate)
    return _compute_device_resident_two_phase(
        db, norms_sq, total, begin_row, end_row, tile, L, d, exact_filter,
        verbose, max_abs, ops, finalize)


# fused-engine tuning: per-tile candidate capacity floor. Small keeps the
# per-tile rank-lookup arrays small; tiles that overflow are retried at
# their exact pow2 capacity (counts come from the same program).
FUSED_CAP_FLOOR = 512
# fixed tile-batch size (one compiled program shape). The combined-buffer
# compaction emits GLOBAL coordinates, so there is no packed-index limit;
# bigger chunks amortize the per-transfer device->host fixed latency.
# Bounded at runtime by the device buffer rule.
FUSED_CHUNK_TILES = 2048


def _compute_device_resident_fused(db, norms_sq, total, begin_row, end_row,
                                   tile, L, d, exact_filter, verbose,
                                   max_abs, ops=None, gate: bool = False):
    """The round-3 single-pass engine: ONE device program per tile chunk
    does sweep + hierarchical compaction + exact finalize partials
    (ops.pairwise.sweep_extract_fused); the host only combines partials
    into exact int64 dots (O(K) work) and applies the reference retention.
    Chunks are pipelined — chunk i+1 is dispatched before chunk i's
    results are read, so host finalize overlaps device compute.

    vs the round-2 two-phase engine this removes: the separate counts
    sweep (a full extra pass of plane matmuls over hot tiles), the
    per-chunk exact-dot gather program (a third pass over the planes),
    and their dispatch round trips."""
    ts = time.perf_counter()
    V, planes, thr_j = _stage_database(db, norms_sq, total, tile, L, d,
                                       max_abs, ops)
    jax_block = getattr(planes, "block_until_ready", None)
    if jax_block:
        jax_block()
    _acc("stage_ms", ts)
    if LAST_STAGES:
        LAST_STAGES["mode"] = "fused"

    npad = ((total + tile - 1) // tile) * tile
    nt = npad // tile
    rt0, rt1 = begin_row // tile, (end_row - 1) // tile + 1
    # TRIANGLE tile grid (round 4): within this shard's row-tile range
    # [rt0, rt1) the grid is symmetric — tiles (r, c) and (c, r) carry the
    # same unordered pairs, and every per-pair quantity is symmetric
    # (exact dot, the 0.05*(|vi|^2+|vj|^2) retention threshold, the
    # quantization) — so only c >= r is swept and the host finalize emits
    # each off-diagonal candidate in BOTH directions (_mirror below).
    # Column tiles outside the row-tile range keep the full rectangle:
    # their mirror rows belong to other shards. ~2x fewer tiles (and ~2x
    # e2e) for the flagship single-shard all-vs-all case. The reference
    # sweeps its full row-block x N rectangle per process
    # (pairwise_comp_optimized.cpp:949-990).
    coords = np.array([(r, c) for r in range(rt0, rt1) for c in range(nt)
                       if c >= r or not rt0 <= c < rt1], dtype=np.int32)
    row_base = coords[:, 0].astype(np.int64) * tile
    col_base = coords[:, 1].astype(np.int64) * tile

    parts, finalize_globals, finalize_dots, exact_dots = _make_finalizer(
        V, norms_sq, begin_row, end_row, total, d, exact_filter, max_abs,
        device_ctx=(planes, L))

    # mirror candidates whose tile-transposed twin (c_tile, r_tile) was
    # dropped from coords above; the begin/end row filter inside the
    # finalizer keeps only this shard's rows either way. Diagonal tiles
    # (ct == rt) already carry both orders and self-pairs are emitted
    # separately — neither is mirrored.
    def _mirror_mask(r_glob, c_glob):
        ct = c_glob // tile
        return (ct > r_glob // tile) & (ct >= rt0) & (ct < rt1)

    def fin_dots(r_glob, c_glob, dots):
        finalize_dots(r_glob, c_glob, dots)
        m = _mirror_mask(r_glob, c_glob)
        if m.any():
            # the dot is symmetric — re-emit, never recompute (count=False:
            # mirror twins are host emissions, not extraction D2H volume)
            finalize_dots(c_glob[m], r_glob[m], dots[m], count=False)

    def fin_globals(r_glob, c_glob):
        # dense-bitmap/retry path: exact dots ONCE per unordered pair, for
        # pairs where EITHER direction lands in this shard's rows, then
        # both directions emitted off the same dot array (the
        # mirrored twin previously recomputed its dots)
        t0 = time.perf_counter()
        m = _mirror_mask(r_glob, c_glob)
        fwd = ((r_glob >= begin_row) & (r_glob < end_row)
               & (c_glob < total))
        rev = m & (c_glob >= begin_row) & (c_glob < end_row)
        need = fwd | rev
        if LAST_STAGES:
            # incoming = device-extracted volume; the count=False emissions
            # below add themselves to 'emitted' only. Out-of-shard drops
            # still count as emitted so 'emitted' means the same thing
            # here as in the two-phase finalizer (r5 review)
            LAST_STAGES["candidates"] += len(r_glob)
            LAST_STAGES["emitted"] += int((~need).sum())
        if not need.any():
            _acc("finalize_ms", t0)
            return
        r, c, mm = r_glob[need], c_glob[need], m[need]
        dots = exact_dots(r, c)
        _acc("finalize_ms", t0)
        finalize_dots(r, c, dots, count=False)
        if mm.any():
            finalize_dots(c[mm], r[mm], dots[mm], count=False)

    # self-pairs (masked out of the kernel so diagonal tiles stay at
    # ordinary density) are emitted directly from the exact self dots —
    # via finalize_globals so they ride the DEVICE exact-dot path (not an
    # O(R*d) float64 host pass); the
    # exact retention + quantization path treats them like any pair
    # (the reference keeps them, pairwise_comp_optimized.cpp:659)
    self_rows = np.arange(begin_row, end_row, dtype=np.int64)
    finalize_globals(self_rows, self_rows.copy())

    _fused_extract_with_retries(planes, thr_j, tile, L, coords, row_base,
                                col_base, fin_dots, fin_globals, ops,
                                gate=gate)
    return _concat(parts)


def _fused_extract_with_retries(planes, thr, tile, L, coords, row_base,
                                col_base, finalize_dots, finalize_globals,
                                ops=None, col_planes=None, col_thr=None,
                                gate: bool = False):
    """Fused extraction at the floor capacity, then: overflow tiles retry
    at exact pow2 capacities; ultra-dense tiles (count > tile^2/32) route
    to the density-independent bitmap path (the per-candidate payload
    would dwarf a bitmap there), finalized via finalize_globals.

    SELF-pairs are masked in-kernel (sweep_extract_fused_ij) — the
    caller emits them directly from exact self dots — so diagonal tiles
    stay at ordinary density and the capacity floor applies uniformly."""
    cap = min(FUSED_CAP_FLOOR, tile * tile)
    retries = _run_fused_extraction(planes, thr, tile, L, coords,
                                    row_base, col_base, cap,
                                    finalize_dots, ops, col_planes,
                                    col_thr, gate=gate)
    if not retries:
        return
    dense_cut = (tile * tile) // 32
    bitmap_ks = [t for t, cc in retries if cc > dense_cut]
    buckets: dict = {}
    for t, cc in retries:
        if cc <= dense_cut:
            buckets.setdefault(_next_pow2(int(cc)), []).append(t)
    for ccap, ks in buckets.items():
        ks = np.asarray(ks)
        # retry batches are all-hot by construction: never gate them
        again = _run_fused_extraction(
            planes, thr, tile, L, coords[ks], row_base[ks],
            col_base[ks], min(ccap, tile * tile), finalize_dots, ops,
            col_planes, col_thr, adapt=False)
        assert not again, "fused retry at exact capacity overflowed"
    if bitmap_ks:
        ks = np.asarray(bitmap_ks)
        _dense_bitmap_extract(planes, thr, tile, coords[ks], row_base[ks],
                              col_base[ks], finalize_globals, ops,
                              col_planes, col_thr)


def _dense_bitmap_extract(planes, thr, tile, coords, row_base, col_base,
                          finalize_globals, ops=None, col_planes=None,
                          col_thr=None, keep_self=False):
    """Bitmap extraction for ultra-dense tiles (tile^2/8 bytes D2H per
    tile regardless of density); exact dots recomputed by
    finalize_globals. Supports the rectangular (streaming) operand form.
    keep_self=False drops diagonal pairs (the fused drivers emit
    self-pairs separately); the two-phase engine passes True (its
    self-pairs flow through ordinary extraction)."""
    scale = ops.max_tiles_scale() if ops is not None else 1
    DENSE_CHUNK = 64 * scale
    for s in range(0, len(coords), DENSE_CHUNK):
        chunk = coords[s:s + DENSE_CHUNK]
        kc = len(chunk)
        K_pad = _next_pow2(kc)
        bcoords = np.zeros((K_pad, 3), dtype=np.int32)
        bcoords[:kc, :2] = chunk[:, :2]
        bcoords[:kc, 2] = 1
        if ops is not None:
            words = ops.sweep_mask_bits(planes, thr, bcoords, tile,
                                        col_planes, col_thr)
        else:
            pj = planes if col_planes is None else col_planes
            tj = thr if col_thr is None else col_thr
            words = np.asarray(pw.sweep_mask_bits_ij(
                planes, thr, pj, tj, jnp.asarray(bcoords), tile))
        sub = max(1, (256 << 20) // (tile * tile))
        for u in range(0, kc, sub):
            ue = min(u + sub, kc)
            bits = np.unpackbits(
                words[u:ue].view(np.uint8).reshape(ue - u, -1),
                axis=1, bitorder="little")
            t_of, local = np.nonzero(bits)
            r_glob = row_base[s + u + t_of] + local // tile
            c_glob = col_base[s + u + t_of] + local % tile
            if keep_self:
                finalize_globals(r_glob, c_glob)
            else:
                # self-pairs are emitted separately by the fused drivers —
                # the bitmap recompute must not double-count them
                keep = r_glob != c_glob
                finalize_globals(r_glob[keep], c_glob[keep])


def _run_fused_extraction(planes, thr_j, tile, L, coords, row_base,
                          col_base, cap_c, finalize_dots, ops=None,
                          col_planes=None, col_thr=None,
                          adapt: bool = True, gate: bool = False):
    """Chunked, pipelined fused extraction over a tile coordinate list.

    Dispatches chunk i+1's device programs before reading chunk i's
    results (JAX async dispatch keeps the device busy while the host
    combines/filters). With col_planes/col_thr the tile space is
    RECTANGULAR: row tiles slice (planes, thr_j), column tiles the col
    operands (the streaming engine's shape). Returns
    [(tile_idx, cand_count)] for tiles that overflowed cap_c and must be
    retried."""
    T = len(coords)
    if T == 0:
        return []
    scale = ops.max_tiles_scale() if ops is not None else 1
    K = min(FUSED_CHUNK_TILES, max(64, _next_pow2(T))) * scale
    PL = pw.num_planes(L)
    # bound the PER-DEVICE (K/scale, cap_c, PL+1) int32 chunk buffers to
    # ~512 MB: K may grow scale x (each device holds only its K/scale
    # tiles' worth)
    K = max(scale, min(K, ((512 << 20) // ((PL + 1) * 4 * cap_c)) * scale))
    assert max(row_base.max(initial=0), col_base.max(initial=0)) + tile \
        <= 2**31 - 1, \
        "global coordinate exceeds int32 (raise tile batching to int64)"

    # out_cap estimate: running mean density with 2x headroom (the light
    # compact program is re-dispatched at the exact size on shortfall —
    # the heavy program's buffers stay resident)
    seen_tiles = 0
    seen_cands = 0
    # counts-ADAPTIVE per-tile capacity (round 4): the floor cap pays
    # selection + partials work proportional to cap_c on EVERY tile, but
    # production-density tiles carry ~40-100 survivors — once observed
    # counts bound the density, later chunks run at a snug pow2 cap
    # (1.25x headroom over the max seen; the authoritative-count overflow
    # retry already guarantees correctness if a later tile exceeds it).
    # One extra heavy-program compile per distinct cap, persistent-cached.
    cur_cap = [cap_c]
    max_seen = [0]

    def adapt_cap():
        # never on retry batches: their caps are EXACT (assert not again)
        if adapt and max_seen[0] > 0:
            tgt = _next_pow2(max(64, int(max_seen[0] * 1.25) + 1))
            cur_cap[0] = min(cap_c, max(64, tgt))

    def estimate(cap):
        if seen_tiles == 0:
            per_tile = max(cap // 8, 16)
        else:
            per_tile = 2 * seen_cands / seen_tiles + 64
        per_dev = int(min(cap * (K // scale),
                          max(16384, per_tile * (K // scale))))
        return ((per_dev + 16383) // 16384) * 16384

    def make_bases(s, e):
        bases = np.zeros((K, 2), dtype=np.int32)
        bases[:e - s, 0] = row_base[s:e]
        bases[:e - s, 1] = col_base[s:e]
        return bases

    def exact_out_cap(cand_counts, e_minus_s, k_pad, cap):
        """Exact per-device out_cap from the authoritative counts — a
        TINY (4 bytes/tile) device read. Used for the FIRST chunk, where
        the running density estimate has no data and a shortfall would
        cost a full second transfer of the big buffer."""
        cc = np.asarray(cand_counts)[:e_minus_s]
        kept = np.minimum(cc.astype(np.int64), cap)
        kept[cc > cap] = 0
        if ops is not None:
            padded = np.zeros(k_pad, dtype=np.int64)
            padded[:e_minus_s] = kept
            per_dev = ops.block_total_max(padded)
        else:
            per_dev = int(kept.sum())
        return ((max(per_dev, 1) + 16383) // 16384) * 16384

    first_dispatch = True

    def dispatch(s):
        nonlocal first_dispatch
        cap = cur_cap[0]
        e = min(s + K, T)
        bcoords = np.zeros((K, 3), dtype=np.int32)
        bcoords[:e - s, :2] = coords[s:e]
        bcoords[:e - s, 2] = 1
        bases = make_bases(s, e)
        if ops is not None:
            cand_idx, partials, cand_counts, k_pad = \
                ops.sweep_extract_fused(planes, thr_j, bcoords, bases,
                                        tile, L, cap, col_planes,
                                        col_thr, gate=gate)
        else:
            pj = planes if col_planes is None else col_planes
            tj = thr_j if col_thr is None else col_thr
            cand_idx, partials, cand_counts = \
                pw.sweep_extract_fused_ij(planes, thr_j, pj, tj,
                                          jnp.asarray(bcoords),
                                          jnp.asarray(bases), tile, L,
                                          cap, gate=gate)
            k_pad = K
        # exact counts only for the FIRST dispatch: a seen_tiles gate
        # would also block the SECOND dispatch on its own counts read
        # (collect for chunk 1 runs after dispatch of chunk 2),
        # serializing the advertised overlap
        out_cap = exact_out_cap(cand_counts, e - s, k_pad, cap) \
            if first_dispatch else estimate(cap)
        first_dispatch = False
        if ops is not None:
            buf = ops.compact_cands_combined(
                cand_counts, cand_idx, partials, bases, tile, out_cap,
                k_pad)
        else:
            buf = pw.compact_cands_combined(
                cand_counts, cand_idx, partials, jnp.asarray(bases), tile,
                out_cap)
        return (s, e, cap, out_cap, cand_idx, partials, cand_counts,
                bases, buf, k_pad)

    retries = []

    def read_split(buf, k_pad, out_cap):
        """ONE host read of the combined buffer (the whole chunk crosses
        D2H in a single transfer), then the per-device split."""
        if ops is not None:
            return ops.split_combined(np.asarray(buf), k_pad, out_cap, PL)
        return pw.split_combined(np.asarray(buf), k_pad, out_cap, PL)

    def collect(job):
        nonlocal seen_tiles, seen_cands
        (s, e, cap, out_cap, cand_idx, partials, cand_counts, bases, buf,
         k_pad) = job
        t0 = time.perf_counter()
        cc, r_glob, c_glob, parts_h = read_split(buf, k_pad, out_cap)
        cc = cc[:e - s]
        seen_tiles += e - s
        seen_cands += int(cc.sum())
        max_seen[0] = max(max_seen[0], int(cc.max(initial=0)))
        adapt_cap()
        over = cc > cap
        retries.extend((s + t, int(cc[t])) for t in np.flatnonzero(over))
        kept = np.minimum(cc.astype(np.int64), cap)
        kept[over] = 0
        if ops is not None:
            padded = np.zeros(k_pad, dtype=np.int64)
            padded[:e - s] = kept
            needed = ops.block_total_max(padded)
        else:
            needed = int(kept.sum())
        if needed > out_cap:
            # shortfall: re-run ONLY the light compaction over the still-
            # resident heavy buffers at the exact (quantized) size
            out_cap = ((needed + 16383) // 16384) * 16384
            if ops is not None:
                buf = ops.compact_cands_combined(
                    cand_counts, cand_idx, partials, bases, tile, out_cap,
                    k_pad)
            else:
                buf = pw.compact_cands_combined(
                    cand_counts, cand_idx, partials, jnp.asarray(bases),
                    tile, out_cap)
            _, r_glob, c_glob, parts_h = read_split(buf, k_pad, out_cap)
        _acc("extract_ms", t0)
        dots = pw.combine_plane_partials(parts_h.T, L)
        finalize_dots(r_glob, c_glob, dots)

    pending = None
    for s in range(0, T, K):
        t0 = time.perf_counter()
        job = dispatch(s)
        _note_dispatch_wall(t0)
        _acc("extract_ms", t0)
        if pending is not None:
            collect(pending)
        pending = job
    collect(pending)
    return retries


def _compute_device_resident_two_phase(db, norms_sq, total, begin_row,
                                       end_row, tile, L, d, exact_filter,
                                       verbose, max_abs, ops=None,
                                       finalize: str = "host"):
    npad = ((total + tile - 1) // tile) * tile
    # V stays host-resident: exact candidate dots are recomputed here with
    # float64 BLAS (pw.exact_dots_host) so only 4 bytes/candidate cross D2H
    ts = time.perf_counter()
    V, planes, thr_j = _stage_database(db, norms_sq, total, tile, L, d,
                                       max_abs, ops)
    jax_block = getattr(planes, "block_until_ready", None)
    if jax_block:
        jax_block()
    _acc("stage_ms", ts)

    nt = npad // tile
    rt0, rt1 = begin_row // tile, (end_row - 1) // tile + 1
    coords = np.array([(r, c) for r in range(rt0, rt1) for c in range(nt)],
                      dtype=np.int32)
    tsw = time.perf_counter()
    if ops is not None:
        # mesh path: every device sweeps its own slice of the tile grid
        counts = ops.sweep_counts(planes, thr_j, coords, tile)
    else:
        counts = np.asarray(pw.sweep_counts(planes, thr_j,
                                            jnp.asarray(coords), tile))
    _acc("sweep_ms", tsw)
    hot = np.flatnonzero(counts > 0)
    if verbose:
        log(f"sweep: {len(coords)} tiles, {len(hot)} hot, "
            f"{int(counts.sum())} candidates")

    device_ctx = (planes, L) if finalize == "device" else None
    parts, finalize_globals, _, _ = _make_finalizer(
        V, norms_sq, begin_row, end_row, total, d, exact_filter, max_abs,
        device_ctx)
    row_base = coords[:, 0].astype(np.int64) * tile
    col_base = coords[:, 1].astype(np.int64) * tile
    te = time.perf_counter()
    fin0 = LAST_STAGES.get("finalize_ms", 0.0)
    _extract_tiles(planes, thr_j, tile, coords, counts, row_base, col_base,
                   finalize_globals, ops)
    _acc("extract_ms", te)
    if LAST_STAGES:  # extraction wall minus the finalize time nested in it
        LAST_STAGES["extract_ms"] -= LAST_STAGES["finalize_ms"] - fin0
    return _concat(parts)


def _make_finalizer(V, norms_sq, begin_row, end_row, total, d, exact_filter,
                    max_abs, device_ctx=None):
    """-> (parts list, finalize_globals(r, c), finalize_dots(r, c, dots)):
    exact finalization of candidate coordinate arrays — apply the
    reference retention semantics, append surviving (rows, cols, dots) to
    parts. finalize_globals recomputes the exact dots first (float64 host
    BLAS from the resident/memory-mapped vectors, or ON DEVICE from the
    resident int8 limbs with device_ctx=(planes, L)); finalize_dots takes
    already-exact int64 dots (the fused engine computes them in-kernel)."""
    parts: list = []

    def finalize_dots(r_glob, c_glob, dots, count: bool = True):
        """count=False: a host-side re-emission (triangle mirror twin) of
        candidates already counted — bookkept under 'emitted' only, so
        LAST_STAGES['candidates'] keeps meaning device-extracted/D2H
        candidate volume."""
        t0 = time.perf_counter()
        if LAST_STAGES:
            if count:
                LAST_STAGES["candidates"] += len(r_glob)
            LAST_STAGES["emitted"] += len(r_glob)
        keep_range = ((r_glob >= begin_row) & (r_glob < end_row)
                      & (c_glob < total))
        if not keep_range.all():
            r_glob, c_glob = r_glob[keep_range], c_glob[keep_range]
            dots = dots[keep_range]
        if len(r_glob) == 0:
            _acc("finalize_ms", t0)
            return
        thr_exact = 0.05 * (norms_sq[r_glob] + norms_sq[c_glob])
        keep = exact_filter(dots, thr_exact, d)
        if keep.any():
            parts.append((r_glob[keep], c_glob[keep], dots[keep]))
        _acc("finalize_ms", t0)

    def exact_dots(r_glob, c_glob):
        """Raw exact int64 dots for candidate coordinate arrays (no range
        filter, no retention) — lets callers that re-emit symmetric twins
        compute each unordered pair's dot ONCE."""
        if device_ctx is not None:
            planes_dev, L_dev = device_ctx
            return pw.exact_dots_device(planes_dev, L_dev, r_glob, c_glob)
        return pw.exact_dots_host(V, r_glob, c_glob, max_abs)

    def finalize_globals(r_glob, c_glob):
        t0 = time.perf_counter()
        keep_range = ((r_glob >= begin_row) & (r_glob < end_row)
                      & (c_glob < total))
        kept_r, kept_c = r_glob[keep_range], c_glob[keep_range]
        if len(kept_r) == 0:
            if LAST_STAGES:
                LAST_STAGES["candidates"] += len(r_glob)
                LAST_STAGES["emitted"] += len(r_glob)
            _acc("finalize_ms", t0)
            return
        dots = exact_dots(kept_r, kept_c)
        _acc("finalize_ms", t0)
        # range filter already applied; count the dropped ones here
        if LAST_STAGES:
            LAST_STAGES["candidates"] += int(len(r_glob) - len(kept_r))
            LAST_STAGES["emitted"] += int(len(r_glob) - len(kept_r))
        finalize_dots(kept_r, kept_c, dots)

    return parts, finalize_globals, finalize_dots, exact_dots


def _extract_tiles(planes, thr_j, tile, coords, counts, row_base, col_base,
                   finalize_globals, ops=None):
    """Shared hot-tile extraction over an arbitrary tile coordinate space.

    Split hot tiles by density: above 1/32 survivors a packed BITMAP
    (tile^2/8 bytes, density-independent) is a cheaper host read than
    4-byte indices. Sparse tiles bucket by capacity; with device-side
    compaction the cap only sizes a transient HBM buffer, so quantize it
    to TWO values (4096, or pow2 of the max count for bigger tiles) —
    fewer distinct program shapes = fewer compiles.

    Args:
      coords: (T, 2) int32 tile indices INTO `planes` (units of `tile`).
      counts: (T,) phase-1 survivor counts (advisory — routes/sizes only).
      row_base/col_base: (T,) int64 GLOBAL element bases per tile.
      finalize_globals: callback taking (r_glob, c_glob) candidate arrays.
      ops: parallel.engine.MeshSweepOps to run the extraction programs
        mesh-sharded over the tile axis (None = single device).
    """
    hot = np.flatnonzero(counts > 0)
    dense_cut = (tile * tile) // 32
    use_dense = (tile * tile) % 32 == 0 and dense_cut > 0
    dense: list[int] = []
    buckets: dict[int, list[int]] = {}
    for k in hot:
        if use_dense and counts[k] > dense_cut:
            dense.append(k)
        else:
            cap = 4096 if counts[k] <= 4096 else _next_pow2(int(counts[k]))
            buckets.setdefault(cap, []).append(k)

    scale = ops.max_tiles_scale() if ops is not None else 1
    max_K = _max_tiles_per_batch(tile) * scale
    max_K_words = _max_words_per_batch(tile) * scale

    def compact(bcoords, cap, out_cap):
        if ops is not None:
            return ops.sweep_compact(planes, thr_j, bcoords, tile, cap,
                                     out_cap)
        return pw.sweep_compact(planes, thr_j, jnp.asarray(bcoords), tile,
                                cap, out_cap)

    # dense tiles: bitmap extraction (shared with the fused engine —
    # chunking, pow2 padding, bounded unpack all live in
    # _dense_bitmap_extract; self-pairs flow through ordinary extraction
    # here, so keep them). The bitmap is its own ground truth — phase-1
    # counts only routed tiles here.
    if dense:
        ks_arr = np.asarray(dense)
        _dense_bitmap_extract(planes, thr_j, tile, coords[ks_arr],
                              row_base[ks_arr], col_base[ks_arr],
                              finalize_globals, ops, keep_self=True)

    # sparse tiles: flat-compacted at 32-bit-WORD granularity (the hot
    # path — per-tile nonzero over tile^2/32 words is ~21x faster than over
    # tile^2 bits; D2H is 8 B per nonzero word). Phase-1 counts size the
    # buffers; the device recount is authoritative — tiles whose nonzero
    # WORD count exceeds the bucket cap are retried at full capacity, and a
    # chunk whose recount total exceeds the compaction capacity is re-read
    # (both fire only if the counts sweep and the extraction program's
    # float32 threshold decisions disagree on a borderline pair; covered by
    # fabricated-count tests).
    wpt = (tile * tile) // 32
    use_words = (tile * tile) % 32 == 0

    def run_sparse(cap, ks):
        retry: list[int] = []
        cap_w = min(cap, wpt) if use_words else cap
        unit = 8 if use_words else 4
        # bound the (K, cap) device buffers to ~512 MB of HBM (per device)
        chunk_max = max(1, min(max_K_words if use_words else max_K,
                               ((512 << 20) // (cap_w * unit)) * scale))
        for s in range(0, len(ks), chunk_max):
            chunk_ks = ks[s:s + chunk_max]
            K_pad = _next_pow2(len(chunk_ks))
            bcoords = np.zeros((K_pad, 3), dtype=np.int32)
            bcoords[:len(chunk_ks), :2] = coords[chunk_ks]
            bcoords[:len(chunk_ks), 2] = 1

            def cap_basis(per_tile):
                """out_cap basis: per-DEVICE block max on a mesh (each
                device's compaction buffer is out_cap wide — sizing from
                the global total would transfer n_devices x the data),
                plain total on one device."""
                if ops is not None:
                    padded = np.zeros(K_pad, dtype=np.int64)
                    padded[:len(chunk_ks)] = per_tile
                    return ops.block_total_max(padded)
                return int(np.asarray(per_tile).sum())

            total_b = cap_basis(counts[chunk_ks])   # words <= candidates
            out_cap = ((total_b + 16383) // 16384) * 16384
            if use_words:
                packed, wvals, _, counts_b = compact_w(bcoords, cap_w, out_cap)
            else:
                packed, counts_b = compact(bcoords, cap_w, out_cap)
                wvals = None
            counts_b = np.asarray(counts_b)[:len(chunk_ks)]
            over = counts_b > cap_w
            if over.any():
                retry.extend(int(chunk_ks[t]) for t in np.flatnonzero(over))
            # the flat buffer holds min(count, cap) entries per tile
            needed = cap_basis(np.minimum(counts_b, cap_w))
            if needed > out_cap:
                out_cap = ((needed + 16383) // 16384) * 16384
                if use_words:
                    packed, wvals, _, _ = compact_w(bcoords, cap_w, out_cap)
                else:
                    packed, _ = compact(bcoords, cap_w, out_cap)
            packed = np.asarray(packed)
            valid = packed >= 0
            ks_arr = np.asarray(chunk_ks)
            if use_words:
                pk = packed[valid].astype(np.int64)
                wv = np.ascontiguousarray(np.asarray(wvals)[valid])
                t_w = pk // wpt
                w_of = pk % wpt
                bits = np.unpackbits(wv.view(np.uint8), bitorder="little") \
                    .reshape(-1, 32)
                wrow, bit = np.nonzero(bits)
                t_of = t_w[wrow]
                local = w_of[wrow] * 32 + bit
            else:
                pk = packed[valid].astype(np.int64)
                t_of = pk // (tile * tile)
                local = pk % (tile * tile)
            if over.any():
                keep = ~over[t_of]                 # retried tiles drop out
                t_of, local = t_of[keep], local[keep]
            finalize_globals(row_base[ks_arr[t_of]] + local // tile,
                             col_base[ks_arr[t_of]] + local % tile)
        return retry

    def compact_w(bcoords, cap_w, out_cap):
        if ops is not None:
            return ops.sweep_compact_words(planes, thr_j, bcoords, tile,
                                           cap_w, out_cap)
        return pw.sweep_compact_words(planes, thr_j, jnp.asarray(bcoords),
                                      tile, cap_w, out_cap)

    for cap, ks in buckets.items():
        retry = run_sparse(cap, ks)
        if retry:
            run_sparse(_next_pow2(tile * tile), retry)


def _compute_streaming(db, norms_sq, total, begin_row, end_row, tile_rows,
                       tile_cols, L, d, exact_filter, budget, max_abs,
                       ops=None, engine: str = "fused",
                       gate: bool = False):
    """Column-streaming fallback for databases too large for device
    residency (the reference's --max_memory_gb chunked operation,
    pairwise_comp_optimized.cpp:903-906, 949-982): the SHARD ROWS are
    staged once per shard (when they fit a third of the budget) and a
    budget-sized WINDOW of column tiles streams past them; the FUSED
    single-pass engine (rectangular operand form) sweeps, compacts and
    emits exact partials per (row tile x window tile). Exact dots for the
    rare ultra-dense bitmap tiles come from a memory-map of vectors.bin
    (a database exceeding HBM should not be fully host-resident either).

    When even one shard's rows exceed the budget share, row tiles are
    staged in budget-sized groups (extra column-window re-uploads, still
    each column window staged once per ROW GROUP, not per row tile)."""
    if engine == "fused" and (tile_rows * tile_rows) % 32 == 0:
        return _compute_streaming_fused(
            db, norms_sq, total, begin_row, end_row, tile_rows, L, d,
            exact_filter, budget, max_abs, ops, gate)
    return _compute_streaming_two_phase(
        db, norms_sq, total, begin_row, end_row, tile_rows, tile_cols, L,
        d, exact_filter, budget, max_abs, ops)


def _streaming_stager(db, norms_sq, total, d, L, max_abs):
    """-> (Vmm, thr_f32, stage(start, end, n_rows)) shared by both
    streaming engines; stage() trust-but-verifies the cached max component
    against every block it loads."""
    vec_dt = np.int16 if db.dtype == "int16" else np.int32
    Vmm = np.memmap(os.path.join(db.path, "vectors.bin"), dtype=vec_dt,
                    mode="r", shape=(total, d))
    adj = pw.threshold_adjust(L, max_abs, d)  # same rule as _stage_database
    thr_f32 = (norms_sq + adj).astype(np.float32)

    def stage(start, end, n_rows):
        """Load rows [start, end) padded to n_rows (thr=+inf padding)."""
        t0 = time.perf_counter()
        block = np.zeros((n_rows, d), dtype=np.int32)
        block[:end - start] = db.load_vectors(start, end).astype(np.int32)
        _check_stale_max(block[:end - start], max_abs, db)
        thr = np.full(n_rows, np.float32(1e30), dtype=np.float32)
        thr[:end - start] = thr_f32[start:end]
        # upload int8 limbs (L B/element H2D) and form the pairwise limb
        # sums on device — streaming re-stages the whole database once per
        # shard, so H2D volume is the staging cost that matters
        limbs = pw.decompose_limbs_host(block, L)
        _acc("stage_decompose_ms", t0)  # approx: prefetch thread may add
        return pw.planes_from_limbs(jnp.asarray(limbs)), jnp.asarray(thr)

    return Vmm, thr_f32, stage


def _compute_streaming_fused(db, norms_sq, total, begin_row, end_row,
                             tile, L, d, exact_filter, budget, max_abs,
                             ops=None, gate: bool = False):
    if LAST_STAGES:
        LAST_STAGES["mode"] = "fused-streaming"
    Vmm, thr_f32, stage = _streaming_stager(db, norms_sq, total, d, L,
                                            max_abs)
    parts, finalize_globals, finalize_dots, _ = _make_finalizer(
        Vmm, norms_sq, begin_row, end_row, total, d, exact_filter, max_abs)

    # self-pairs: masked in-kernel, emitted directly (see the resident
    # engine) — exact self dots from the vectors memmap, timed under
    # finalize_ms
    self_rows = np.arange(begin_row, end_row, dtype=np.int64)
    finalize_globals(self_rows, self_rows.copy())

    P = pw.num_planes(L)
    bytes_per_tile = P * tile * d
    # budget quarters: the resident row planes, the column window being
    # swept, the NEXT column window (prefetched on a background thread
    # while the current one is extracted — staging is disk + limb
    # decompose + H2D, all of which overlap device compute), and staging
    # temporaries (decompose/planes_from_limbs peaks)
    share = max(budget // 4, 2 * bytes_per_tile)
    R = end_row - begin_row
    rg_tiles = max(1, min((R + tile - 1) // tile, share // bytes_per_tile))
    window_tiles = max(1, int(share // bytes_per_tile))

    def stage_cols(ws, we):
        n_w = (we - ws + tile - 1) // tile
        p, t = stage(ws, we, n_w * tile)
        if ops is not None:
            p, t = ops.replicate(p, t)
        return p, t, n_w

    windows = [(ws, min(ws + window_tiles * tile, total))
               for ws in range(0, total, window_tiles * tile)]
    # flattened (row group, window) schedule so the one-deep prefetch also
    # covers the first window of the NEXT row group (the window sequence
    # restarts identically for every row group)
    schedule = [(rg, w) for rg in range(begin_row, end_row,
                                        rg_tiles * tile) for w in windows]

    with ThreadPoolExecutor(max_workers=1) as pool:
        fut = None
        cur_rg = None
        for si, (rg, (ws, we)) in enumerate(schedule):
            if rg != cur_rg:
                rg_end = min(rg + rg_tiles * tile, end_row)
                n_r = (rg_end - rg + tile - 1) // tile
                ts = time.perf_counter()
                planes_r, thr_r = stage(rg, rg_end, n_r * tile)
                if ops is not None:
                    planes_r, thr_r = ops.replicate(planes_r, thr_r)
                _acc("stage_ms", ts)
                row_base_tiles = rg + np.arange(n_r, dtype=np.int64) * tile
                cur_rg = rg
            ts = time.perf_counter()
            if fut is None:
                planes_w, thr_w, n_w = stage_cols(ws, we)
            else:
                planes_w, thr_w, n_w = fut.result()
            if si + 1 < len(schedule):
                fut = pool.submit(stage_cols, *schedule[si + 1][1])
            else:
                fut = None
            _acc("stage_ms", ts)
            coords = np.array([(ri, wj) for ri in range(n_r)
                               for wj in range(n_w)], dtype=np.int32)
            row_base = np.repeat(row_base_tiles, n_w)
            col_base = np.tile(ws + np.arange(n_w, dtype=np.int64) * tile,
                               n_r)
            _fused_extract_with_retries(
                planes_r, thr_r, tile, L, coords, row_base, col_base,
                finalize_dots, finalize_globals, ops,
                col_planes=planes_w, col_thr=thr_w, gate=gate)
    return _concat(parts)


def _compute_streaming_two_phase(db, norms_sq, total, begin_row, end_row,
                                 tile_rows, tile_cols, L, d, exact_filter,
                                 budget, max_abs, ops=None):
    """The round-2 streaming engine (kept for engine='two_phase' and
    non-32-divisible tiles): one row tile plus a budget-sized window of
    column tiles staged as a single concatenated device tensor, counts
    sweep + shared hot-tile extraction per (window x row tile).

    Known trade-off: row tiles are re-staged once per
    column window here; the DEFAULT fused streaming engine stages shard
    rows once per shard via rectangular kernels. Deliberately not ported —
    this path only serves odd tile sizes, and churning a tested fallback
    for its cold path isn't worth the risk."""
    tile = tile_rows
    P = pw.num_planes(L)
    bytes_per_tile = P * tile * d
    # peak device memory is ~3x the window planes (concat input + output +
    # staging temporaries inside decompose_planes), so size the window to
    # about a third of the budget
    window_tiles = max(1, int(max(budget // 3, 2 * bytes_per_tile)
                              // bytes_per_tile) - 1)
    Vmm, _, stage = _streaming_stager(db, norms_sq, total, d, L, max_abs)
    parts, finalize_globals, _, _ = _make_finalizer(
        Vmm, norms_sq, begin_row, end_row, total, d, exact_filter, max_abs)

    # windows outer, row tiles inner: each column window is uploaded and
    # decomposed exactly ONCE per shard (the column side dominates staging)
    for ws in range(0, total, window_tiles * tile):
        we = min(ws + window_tiles * tile, total)
        n_w = (we - ws + tile - 1) // tile
        ts = time.perf_counter()
        planes_w, thr_w = stage(ws, we, n_w * tile)
        _acc("stage_ms", ts)
        coords = np.array([(0, 1 + j) for j in range(n_w)], dtype=np.int32)
        # bases are global: the row tile (staged index 0) holds global rows
        # bi..; staged col tile 1+j holds global columns ws + j*tile..
        col_base = ws + np.arange(n_w, dtype=np.int64) * tile
        for bi in range(begin_row, end_row, tile):
            ei = min(bi + tile, end_row)
            tsw = time.perf_counter()
            planes_r, thr_r = stage(bi, ei, tile)
            planes_cat = jnp.concatenate([planes_r, planes_w], axis=1)
            thr_cat = jnp.concatenate([thr_r, thr_w])
            if ops is not None:
                planes_cat, thr_cat = ops.replicate(planes_cat, thr_cat)
                counts = ops.sweep_counts(planes_cat, thr_cat, coords, tile)
            else:
                counts = np.asarray(pw.sweep_counts(
                    planes_cat, thr_cat, jnp.asarray(coords), tile))
            _acc("sweep_ms", tsw)
            row_base = np.full(n_w, bi, dtype=np.int64)
            te = time.perf_counter()
            fin0 = LAST_STAGES.get("finalize_ms", 0.0)
            _extract_tiles(planes_cat, thr_cat, tile, coords, counts,
                           row_base, col_base, finalize_globals, ops)
            _acc("extract_ms", te)
            if LAST_STAGES:
                LAST_STAGES["extract_ms"] -= LAST_STAGES["finalize_ms"] - fin0
    return _concat(parts)


def compute_minhash_shard(hashes_file: str, output_folder: str,
                          num_shards: int = 1, shard_idx: int = 0,
                          db_folder: str | None = None,
                          verbose: bool = True) -> str:
    """MinHash-strategy pairwise shard (the reference's historical
    --strategy 1): EXACT set Jaccard from the raw hash sets via device
    incidence matmuls (ops.minhash), written in the active matrix format.

    If db_folder is given, its vector_norms.txt order defines the indices;
    otherwise a minimal db folder 'minhash_db' is written next to the matrix
    (norm = sqrt(|set|), so norm^2 is the exact |A| — the same contract the
    sketch path's norms estimate), making the whole query stack work
    unchanged.
    """
    from ..io.hashes import parse_hashes_file
    from ..io.dbfolder import DbFolder
    from ..ops import minhash

    named = parse_hashes_file(hashes_file)
    names = [n for n, _ in named]
    sets_ = [h for _, h in named]
    if db_folder:
        order = DbFolder(db_folder).names_and_norms()[0]
        index = {n: i for i, n in enumerate(names)}
        sets_ = [sets_[index[n]] for n in order]
        names = order

    total = len(names)
    rows_per_shard = (total + num_shards - 1) // num_shards
    begin_row = shard_idx * rows_per_shard
    end_row = min(begin_row + rows_per_shard, total)
    if verbose:
        log(f"MinHash shard {shard_idx}: rows {begin_row} to {end_row} of {total}")

    t0 = time.perf_counter()
    r, c, inter, sizes = minhash.minhash_triples(sets_)
    keep = (r >= begin_row) & (r < end_row)
    r, c, inter = r[keep], c[keep], inter[keep]
    if verbose:
        log(f"Total computation time: {(time.perf_counter()-t0)*1000:.0f} ms "
            f"({len(r)} surviving pairs)")

    if not db_folder:
        mdb = os.path.join(output_folder, "minhash_db")
        os.makedirs(mdb, exist_ok=True)
        with open(os.path.join(mdb, "vector_norms.txt"), "w") as f:
            for n, s in zip(names, sizes):
                f.write(f"{n} {np.sqrt(float(s)):.6g}\n")
        with open(os.path.join(mdb, "dimension.txt"), "w") as f:
            f.write("1\n")
        with open(os.path.join(mdb, "dtype.txt"), "w") as f:
            f.write("minhash\n")

    shard_folder = os.path.join(output_folder, f"shard_{shard_idx}")
    # dimension=1 and norms_sq=|A| make the writer's J = inter/(|A|+|B|-inter)
    # the exact set Jaccard
    writer.write_shard(shard_folder, r, c, inter.astype(np.int64),
                       sizes.astype(np.float64), dimension=1)
    return shard_folder


def compute_pairwise_oracle(vectors: np.ndarray, norms_sq: np.ndarray,
                            dimension: int, dtype: str = "int32",
                            row_range: tuple[int, int] | None = None):
    """Brute-force float64/int64 numpy oracle of the reference semantics —
    used by the conformance tests (the reference pairwise binary cannot be
    built: its `bits` submodule is unpinned/empty)."""
    n = vectors.shape[0]
    lo, hi = row_range if row_range else (0, n)
    v = vectors.astype(np.int64)
    rows, cols, vals = [], [], []
    for i in range(lo, hi):
        dots = v[i] @ v.T  # exact int64
        thr = 0.05 * (norms_sq[i] + norms_sq)
        if dtype == "int16":
            keep = dots.astype(np.float64) / dimension > thr
        else:
            q = np.where(dots >= 0, dots // dimension, -((-dots) // dimension))
            keep = q.astype(np.float64) > thr
        j = np.flatnonzero(keep)
        rows.append(np.full(len(j), i, dtype=np.int64))
        cols.append(j.astype(np.int64))
        vals.append(dots[j])
    return (np.concatenate(rows), np.concatenate(cols), np.concatenate(vals))
