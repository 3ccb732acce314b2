"""Pairwise similarity kernels: exact integer dot products at int8
matrix-unit speed.

The reference's flagship compute is a blocked int32 GEMM with a sparsity
threshold (pairwise_comp_optimized.cpp:57-160). Accelerators run integer
matmuls fastest at int8 (the GPU's int8 tensor cores), so we decompose each
int32 component into BALANCED base-128 digits:

    v = sum_k limb_k * 2^(7k),   limb_k in [-64, 63] for every k (incl. top)

so the exact dot is  dot(x, y) = sum_{a,b} 2^{7(a+b)} * dot(limb_a(x), limb_b(y))
with every partial dot an int8 x int8 -> int32 matmul (exact: each partial
is bounded by d * 64^2 << 2^31). Balanced digits buy a Karatsuba-style
combine: limb sums fit int8 (|limb_a + limb_b| <= 128), so the two cross
terms of each unordered pair collapse into ONE matmul,

    p_ab + p_ba = (A_a+A_b)(B_a+B_b)^T - P_aa - P_bb,

cutting the sweep from L^2 to L(L+1)/2 matmuls (4 -> 3 for the int32 path,
9 -> 6 for int16). The sum operands are PRECOMPUTED once as extra "planes"
of the device-resident database (:func:`karatsuba_planes`), so the hot loop
is a plain weighted sum of plane matmuls — the subtraction folds into the
diagonal weights (:func:`plane_weights`) — with zero per-tile elementwise
work on the int8 operands. See :func:`approx_dot_f32`.

On device the float32 approximation of the combined dot is thresholded with
conservative slack and the surviving coordinates are compacted (flat indices
for sparse tiles, packed bitmaps for dense ones) — the only bytes that cross
device->host. Exact dots are recomputed on host from the resident int32
vectors (:func:`exact_dots_host`); the exact threshold (integer division
semantics for the int32 path, float division for the int16 path —
pairwise_comp_optimized.cpp:139-141 vs pairwise_comp_optimized_16bits.cpp:218)
and the Jaccard quantization all happen on host in float64, bit-equal to the
reference math.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from ..utils import compilecache
compilecache.ensure()


def _balanced_top(v: int, L: int) -> int:
    """Top digit of the balanced base-128 decomposition of python int v."""
    cur = v
    for _ in range(L - 1):
        digit = ((cur + 64) % 128) - 64
        cur = (cur - digit) >> 7          # exact: cur - digit divisible by 128
    return cur


def _limbs_ok(max_abs: int, L: int) -> bool:
    if L == 1:
        # single limb: no cross sums, plain int8 range suffices
        return -128 <= -max_abs and max_abs <= 127
    # every limb (incl. top) must land in [-64, 63] so limb SUMS fit int8
    # (_balanced_top is monotone in v, so endpoints suffice)
    return -64 <= _balanced_top(-max_abs, L) and _balanced_top(max_abs, L) <= 63


def pick_limbs(max_abs: int) -> int:
    L = 1
    while not _limbs_ok(max_abs, L):
        L += 1
    return L


def check_exact_dot_range(d: int, max_abs: int) -> None:
    """Reject up front a database whose worst-case dot d*max_abs^2 could
    wrap int64: every exact path (combine_plane_partials on the fused
    engine, exact_dots_device, the int8 ANN combine) accumulates exact
    dots in int64 and would CORRUPT silently past 2^62 — the failure must
    be loud and immediate, like exact_dots_host's assert."""
    if int(d) * (int(max_abs) ** 2) >= (1 << 62):
        raise ValueError(
            f"|components| up to {max_abs} at d={d} put the worst-case dot "
            f"d*max^2 = {int(d) * int(max_abs) ** 2:.3e} beyond the exact "
            "int64 range (2^62) — this database cannot be processed "
            "exactly")


@functools.partial(jax.jit, static_argnames=("L",))
def decompose_limbs(v, L: int):
    """(n, d) int32 -> (L, n, d) int8 balanced base-128 digits.

    Every digit lands in [-64, 63] (for L > 1), so the sum of any two digits
    fits int8 — the property :func:`approx_dot_f32`'s Karatsuba combine needs.
    Reconstruction is the plain radix identity v = sum_k limb_k * 2^(7k).
    """
    v = v.astype(jnp.int32)
    limbs = []
    cur = v
    for _ in range(L - 1):
        digit = ((cur + 64) & 127) - 64   # balanced remainder in [-64, 63]
        limbs.append(digit.astype(jnp.int8))
        cur = (cur - digit) >> 7          # exact arithmetic shift
    limbs.append(cur.astype(jnp.int8))
    return jnp.stack(limbs)


def num_planes(L: int) -> int:
    return L * (L + 1) // 2


def limbs_from_planes(P: int) -> int:
    """Inverse of num_planes (planes count is 1, 3, 6, 10, ... for L=1,2,3,4)."""
    L = int((np.sqrt(8 * P + 1) - 1) / 2 + 0.5)
    assert num_planes(L) == P, f"not a plane count: {P}"
    return L


def plane_weights(L: int) -> np.ndarray:
    """float32 combine weights for the Karatsuba plane matmuls.

    Plane order: the L limbs, then the sums limb_a+limb_b for a < b in
    lexicographic order. From
        dot = sum_k 2^{14k} P_kk + sum_{a<b} 2^{7(a+b)} (M_ab - P_aa - P_bb)
    the subtraction folds into the diagonal weights:
        w_diag(k)    = 2^{14k} - sum_{j != k} 2^{7(k+j)}
        w_pair(a,b)  = 2^{7(a+b)}
    The weights are integers, exactly representable in float32 up to L=4;
    at L=5 a diagonal weight needs >24 mantissa bits (relative error
    ~4e-9), which :func:`required_slack_abs` budgets explicitly.
    """
    w = [float(1 << (14 * k)) - sum(float(1 << (7 * (k + j)))
                                    for j in range(L) if j != k)
         for k in range(L)]
    w += [float(1 << (7 * (a + b))) for a in range(L) for b in range(a + 1, L)]
    return np.asarray(w, dtype=np.float32)


def plane_weights_int(L: int) -> np.ndarray:
    """int64 combine weights for Karatsuba plane partials (same derivation
    as :func:`plane_weights`): given the EXACT int32 per-plane partial dots
    S_p, ``plane_weights_int(L) @ S`` is the exact int64 dot product. Used
    by consumers that keep plane partials (the int-exact ANN engine) instead
    of re-gathering vectors."""
    w = [(1 << (14 * k)) - sum(1 << (7 * (k + j))
                               for j in range(L) if j != k)
         for k in range(L)]
    w += [1 << (7 * (a + b)) for a in range(L) for b in range(a + 1, L)]
    return np.asarray(w, dtype=np.int64)


def karatsuba_planes(limbs):
    """(L, n, d) int8 balanced limbs -> (L(L+1)/2, n, d) int8 planes: the
    limbs followed by the pairwise limb sums (|sum| <= 128 fits int8 because
    the digits are balanced). Precomputed ONCE so the hot sweep is pure
    matmuls. The first L planes ARE the limbs (the exact-dot path uses them).
    """
    L = limbs.shape[0]
    sums = [limbs[a] + limbs[b] for a in range(L) for b in range(a + 1, L)]
    if not sums:
        return limbs
    return jnp.concatenate([limbs, jnp.stack(sums)], axis=0)


@functools.partial(jax.jit, static_argnames=("L",))
def decompose_planes(v, L: int):
    """(n, d) int32 -> (L(L+1)/2, n, d) int8 Karatsuba planes (the hot-path
    database representation: balanced limbs + pairwise limb sums)."""
    return karatsuba_planes(decompose_limbs.__wrapped__(v, L))


def decompose_limbs_host(v: np.ndarray, L: int) -> np.ndarray:
    """numpy mirror of :func:`decompose_limbs` — staging uploads the L int8
    limbs (L bytes/element H2D) instead of the int32 vectors (4 B/element),
    halving host->device traffic for the common L=2 databases; the device
    only forms the pairwise limb sums (:func:`planes_from_limbs`).

    Buffer-reusing formulation (r5): with t = cur + 64, the balanced digit
    is (t & 127) - 64 and the next limb is exactly t >> 7 (arithmetic) —
    cur - digit == (t >> 7) << 7 + 64 - 64... proof: write cur = 128*q + r
    with r in [-64, 63]; then t = 128*q + (r + 64), r + 64 in [0, 127], so
    t >> 7 == q and t & 127 == r + 64. Cuts the per-limb passes from ~6
    temporaries to 3 in-place ops (the host decompose is the largest
    single-host cost of staging a big db through a thin link)."""
    t = v.astype(np.int32, copy=True)
    limbs = np.empty((L,) + v.shape, dtype=np.int8)
    for k in range(L - 1):
        np.add(t, 64, out=t)
        np.bitwise_and(t, 127, out=limbs[k], casting="unsafe")
        limbs[k] -= 64
        np.right_shift(t, 7, out=t)       # exact arithmetic shift of t
    limbs[L - 1] = t
    return limbs


planes_from_limbs = jax.jit(karatsuba_planes)

# jitted limbs-only decomposition for the device staging path (one program
# per chunk instead of eager per-op dispatches)
decompose_limbs_device = functools.partial(
    jax.jit, static_argnames=("L",))(decompose_limbs)


@functools.partial(jax.jit, donate_argnums=(0,))
def planes_update(buf, limbs, start):
    """Write one chunk's planes into the big (P, Npad, d) int8 buffer IN
    PLACE (donated) at row `start`. Chunked staging keeps peak device
    memory at planes + one chunk — materializing the full int32 array next
    to its planes (round-2 staging) OOMed 16 GB HBM at N=1M x 2048."""
    return jax.lax.dynamic_update_slice(
        buf, karatsuba_planes(limbs), (0, start, 0))


def approx_dot_f32(vi_planes, vj_planes):
    """float32 approximation of the exact integer dot tile from Karatsuba
    planes, in L(L+1)/2 plain int8 matmuls (no elementwise work).

    float32 rounding: each plane product is bounded by d*128^2, so converting
    the int32 partials to float32 loses at most ~1 ulp each before the
    weighted accumulation. Because balanced digits cancel, the sum of
    |weighted terms| can exceed |dot|, so the certified error bound is
    :func:`required_slack_abs` (a function of L, max_abs, d) — the engine
    widens the sweep threshold when that bound exceeds the fixed SLACK_ABS.
    """
    P = vi_planes.shape[0]
    weights = plane_weights(limbs_from_planes(P))

    def mm(x, y):
        return jax.lax.dot_general(
            x, y, dimension_numbers=(((1,), (1,)), ((), ())),
            preferred_element_type=jnp.int32)

    approx = mm(vi_planes[0], vj_planes[0]).astype(jnp.float32) * weights[0]
    for p in range(1, P):
        approx = approx + mm(vi_planes[p], vj_planes[p]).astype(jnp.float32) * weights[p]
    return approx


# Retention-threshold slack of the float32 sweep: the exact host re-filter
# removes false positives, so the slack only needs to bound the float32
# rounding of approx_dot_f32 against false NEGATIVES (relative term covers
# ulp(dot)-scale error on large dots, absolute term the weighted-combine
# noise floor on small ones). SLACK_ABS covers every realistic sketch db
# (required_slack_abs < 16 for max_abs up to ~4000 at d=2048); the engine
# certifies this per run and widens the threshold itself when the bound is
# larger (extreme int16-range components), so no pair is silently dropped.
SLACK_REL = np.float32(1.0 - 1e-5)
SLACK_ABS = np.float32(16.0)


def plane_value_bounds(L: int, max_abs: int) -> list[int]:
    """Per-plane max |value| bound for a database whose components are
    bounded by max_abs: low limbs hit +-64 regardless, the TOP limb is
    bounded by the balanced decomposition of +-max_abs, and each sum plane
    by the sum of its two limb bounds."""
    if L == 1:
        return [min(max_abs, 128)]
    top = max(abs(_balanced_top(-max_abs, L)), abs(_balanced_top(max_abs, L)))
    m = [64] * (L - 1) + [top]
    return m + [m[a] + m[b] for a in range(L) for b in range(a + 1, L)]


def required_slack_abs(L: int, max_abs: int, d: int) -> float:
    """Certified bound on |approx_dot_f32 - exact dot| / d.

    Each plane partial P_p is an exact int32 whose float32 conversion loses
    <= eps32 * |P_p| <= eps32 * d * m_p^2; the P-term weighted accumulation
    adds <= (P-1) * eps32 * sum_p |w_p| * d * m_p^2 (the running sum is
    bounded by the total absolute mass, which under balanced-digit
    cancellation can exceed |dot| — the reason this bound, not ulp(dot),
    is the honest slack). One extra factor of margin on top."""
    L = int(L)
    w = np.abs(plane_weights(L)).astype(np.float64)
    m = np.asarray(plane_value_bounds(L, max_abs), dtype=np.float64)
    P = num_planes(L)
    eps = 2.0 ** -24
    total_mass = float(np.sum(w * m * m))  # per unit of d
    # weight-quantization term: at L >= 5 the float32 weights deviate from
    # the exact integers (plane_weights docstring); each plane contributes
    # |w32_p - w_p| * |P_p| <= quant_p * m_p^2 * d of EXTRA error the
    # rounding budget above does not cover
    quant = np.abs(plane_weights(L).astype(np.float64)
                   - plane_weights_int(L).astype(np.float64))
    quant_mass = float(np.sum(quant * m * m))
    return (P + 1) * eps * total_mass + quant_mass


def extra_threshold_margin(L: int, max_abs: int, d: int) -> float:
    """How much each squared-norm entry must be LOWERED before the sweep so
    the effective absolute slack covers required_slack_abs: the sweep
    compares approx/d > 0.05*(ti+tj)*REL - SLACK_ABS, so subtracting e from
    both ti and tj adds 0.1*e of absolute slack. Returns e (0 for every
    realistic db)."""
    need = required_slack_abs(L, max_abs, d)
    return max(0.0, (need - float(SLACK_ABS)) * 10.0)


def threshold_adjust(L: int, max_abs: int, d: int) -> float:
    """Signed per-entry squared-norm adjustment unifying BOTH slack
    directions. The sweep compares approx/d > 0.05*(ti+tj)*REL - SLACK_ABS;
    adding a to every entry shifts (ti+tj) by 2a, i.e. removes
    0.05*2a = 0.1*a of absolute slack. Negative return = widen, exactly
    extra_threshold_margin's case (certified float32 combine error above
    SLACK_ABS); positive = TIGHTEN the effective slack down to
    max(1.0, 2*required_slack_abs). Tightening matters for small-norm
    databases: accessions with only a few hundred FracMinHash hashes have
    ns ~ |hashes|, so a fixed absolute slack of 16 can eat most of the
    0.05*(ni+nj) retention threshold and pass a CONSTANT FRACTION of all
    pairs to the exact finalize (measured r5: 1.54e9 sweep candidates for
    441k true pairs at N=262,144 with 256-hash accessions — a 3,400 s
    host finalize for a 4 s extraction). The exact re-filter makes this a
    pure-cost bug, never a correctness one; the tightened slack keeps a
    >= 2x certified margin against false negatives."""
    need = required_slack_abs(L, max_abs, d)
    target = max(1.0, min(2.0 * need, max(float(SLACK_ABS), need)))
    return (float(SLACK_ABS) - target) * 10.0


def sweep_counts_impl(planes, thr, tile_coords, tile: int):
    """Survivor counts for a batch of (row_tile, col_tile) coordinate pairs,
    as ONE jitted lax.scan — the whole-sweep hot loop. Nothing bigger than a
    per-tile scalar leaves the fused matmul+threshold epilogue, and one
    dispatch covers thousands of tiles (dispatch/D2H latency amortized).

    Args:
      planes: (P, Npad, d) int8 Karatsuba planes (:func:`decompose_planes`)
        of the whole (padded) database, device-resident. Padding rows must
        have thr = +inf so they never pass.
      thr:   (Npad,) float32 squared norms.
      tile_coords: (T, 2) int32 — (row_tile_index, col_tile_index) pairs.
      tile: static tile edge (Npad % tile == 0).

    Returns: (T,) int32 survivor counts per tile.
    """
    P, Npad, d = planes.shape

    def tile_fn(carry, rc):
        r, c = rc[0], rc[1]
        vi = jax.lax.dynamic_slice(planes, (0, r * tile, 0), (P, tile, d))
        vj = jax.lax.dynamic_slice(planes, (0, c * tile, 0), (P, tile, d))
        thr_i = jax.lax.dynamic_slice(thr, (r * tile,), (tile,))
        thr_j = jax.lax.dynamic_slice(thr, (c * tile,), (tile,))
        approx = approx_dot_f32(vi, vj)
        passes = approx / np.float32(d) > \
            0.05 * (thr_i[:, None] + thr_j[None, :]) * SLACK_REL - SLACK_ABS
        return carry, jnp.sum(passes.astype(jnp.int32))

    _, counts = jax.lax.scan(tile_fn, None, tile_coords)
    return counts


sweep_counts = jax.jit(sweep_counts_impl, static_argnames=("tile",))




@functools.partial(jax.jit, static_argnames=("tile", "cap"))
def sweep_candidates(planes, thr, coords, tile: int, cap: int):
    """Batched candidate extraction: per-tile compacted in-tile indices, all
    device-resident (the heavy program — compile key is (K, cap, tile) only).

    Args:
      coords: (K, 3) int32 — (row_tile, col_tile, valid); invalid rows are
        compile-cache padding and contribute nothing.
      cap: static per-tile capacity (must hold every tile's true count).

    Returns device arrays (idx (K, cap) int32 with -1 padding,
    counts (K,) int32).
    """
    P, npad, d = planes.shape

    def one(carry, rc):
        r, c, valid = rc[0], rc[1], rc[2]
        vi = jax.lax.dynamic_slice(planes, (0, r * tile, 0), (P, tile, d))
        vj = jax.lax.dynamic_slice(planes, (0, c * tile, 0), (P, tile, d))
        thr_i = jax.lax.dynamic_slice(thr, (r * tile,), (tile,))
        thr_j = jax.lax.dynamic_slice(thr, (c * tile,), (tile,))
        approx = approx_dot_f32(vi, vj)
        passes = (approx / np.float32(d) >
                  0.05 * (thr_i[:, None] + thr_j[None, :]) * SLACK_REL
                  - SLACK_ABS) & (valid > 0)
        flat = passes.reshape(-1)
        count = jnp.sum(flat.astype(jnp.int32))
        idx = jnp.nonzero(flat, size=cap, fill_value=-1)[0].astype(jnp.int32)
        return carry, (idx, count)

    _, (idx, counts) = jax.lax.scan(one, None, coords)
    return idx, counts


@functools.partial(jax.jit, static_argnames=("tile", "out_cap"))
def compact_indices(idx, tile: int, out_cap: int):
    """(K, cap) per-tile indices -> ONE flat exactly-sized packed array
    (t * tile^2 + in-tile idx, row-major per tile, -1 tail padding). The
    small second program — only it re-compiles when the output size changes."""
    K = idx.shape[0]
    assert K * tile * tile <= 2**31 - 1, "packed index would overflow int32"
    t_ids = jnp.arange(K, dtype=jnp.int32)[:, None]
    packed = jnp.where(idx >= 0, t_ids * (tile * tile) + idx, -1).reshape(-1)
    pos = jnp.nonzero(packed >= 0, size=out_cap, fill_value=-1)[0]
    return jnp.where(pos >= 0, packed[jnp.maximum(pos, 0)], -1)


@functools.partial(jax.jit, static_argnames=("tile",))
def sweep_mask_bits_ij(planes_i, thr_i_all, planes_j, thr_j_all, coords,
                       tile: int):
    """Batched candidate extraction as BITMAPS over a rectangular tile
    space (row tiles from planes_i, column tiles from planes_j — pass the
    same array twice for the symmetric case): one packed uint32 word per
    32 tile slots (tile^2/8 bytes per tile D2H, independent of density) —
    cheaper than 4-byte indices whenever more than 1/32 of a tile survives
    (dense regions: clusters of near-identical accessions).

    Args:
      coords: (K, 3) int32 (row_tile, col_tile, valid).

    Returns (K, tile*tile//32) uint32; bit n of word w (little) is flat slot
    32*w + n in row-major (ti, tj) order — np.unpackbits(bitorder='little')
    on the byte view restores the flat mask.
    """
    P, _, d = planes_i.shape
    lane = jnp.arange(32, dtype=jnp.uint32)

    def one(carry, rc):
        r, c, valid = rc[0], rc[1], rc[2]
        vi = jax.lax.dynamic_slice(planes_i, (0, r * tile, 0), (P, tile, d))
        vj = jax.lax.dynamic_slice(planes_j, (0, c * tile, 0), (P, tile, d))
        thr_i = jax.lax.dynamic_slice(thr_i_all, (r * tile,), (tile,))
        thr_j = jax.lax.dynamic_slice(thr_j_all, (c * tile,), (tile,))
        approx = approx_dot_f32(vi, vj)
        passes = (approx / np.float32(d) >
                  0.05 * (thr_i[:, None] + thr_j[None, :]) * SLACK_REL
                  - SLACK_ABS) & (valid > 0)
        grouped = passes.reshape(-1, 32).astype(jnp.uint32)
        words = jnp.sum(grouped << lane, axis=1).astype(jnp.uint32)
        return carry, words

    _, words = jax.lax.scan(one, None, coords)
    return words


def sweep_mask_bits(planes, thr, coords, tile: int):
    """Symmetric (all-vs-all) wrapper of :func:`sweep_mask_bits_ij`."""
    return sweep_mask_bits_ij(planes, thr, planes, thr, coords, tile)


def sweep_compact(planes, thr, coords, tile: int, cap: int, out_cap: int):
    """sweep_candidates + compact_indices: the candidates of all K tiles
    leave the device as ONE exactly-sized int32 index array — 4 bytes per
    candidate, the engine's entire per-candidate D2H budget (exact dots are
    recomputed on host from the resident int32 vectors with float64 BLAS,
    which is exact for every representable db: |dot| <= d * max^2 < 2^53).

    Returns (packed (out_cap,) int32 device array, counts (K,) int32).

    NOTE: this is the engine's FALLBACK for tiles with tile^2 % 32 != 0;
    the production path is :func:`sweep_compact_words` — per-tile
    jnp.nonzero over tile^2 bits costs far more than the word-level
    compaction."""
    idx, counts = sweep_candidates(planes, thr, coords, tile, cap)
    return compact_indices(idx, tile, out_cap), counts


@functools.partial(jax.jit, static_argnames=("tile", "cap_words"))
def sweep_words(planes, thr, coords, tile: int, cap_words: int):
    """Batched candidate extraction at 32-bit-WORD granularity: per tile,
    the mask is packed into tile^2/32 uint32 words and only the NONZERO
    words are compacted — the jnp.nonzero compaction runs over tile^2/32
    elements instead of tile^2. D2H cost is 8 bytes per nonzero word
    (<= 8 bytes per candidate, less when candidates cluster within words).

    Requires tile*tile % 32 == 0.

    Returns (widx (K, cap_words) int32 word indices with -1 padding,
             wvals (K, cap_words) uint32 word values,
             cand_counts (K,) int32 true candidate counts,
             word_counts (K,) int32 true nonzero-word counts).
    """
    P, npad, d = planes.shape
    # bit packing as two exact f32 MATMULS when tile % 32 == 0 (each word
    # column has <= 16 contributing bits, so partial sums stay < 2^16 —
    # exactly representable)
    pack = _pack_words_fns(tile)

    def one(carry, rc):
        r, c, valid = rc[0], rc[1], rc[2]
        vi = jax.lax.dynamic_slice(planes, (0, r * tile, 0), (P, tile, d))
        vj = jax.lax.dynamic_slice(planes, (0, c * tile, 0), (P, tile, d))
        thr_i = jax.lax.dynamic_slice(thr, (r * tile,), (tile,))
        thr_j = jax.lax.dynamic_slice(thr, (c * tile,), (tile,))
        approx = approx_dot_f32(vi, vj)
        passes = (approx / np.float32(d) >
                  0.05 * (thr_i[:, None] + thr_j[None, :]) * SLACK_REL
                  - SLACK_ABS) & (valid > 0)
        words = pack(passes)
        nz = words != jnp.uint32(0)
        # compact the first cap_words nonzero word indices via top_k over
        # descending index scores (the first-cap semantics of
        # jnp.nonzero(size=...): scores strictly decrease with index, zero
        # words score 0)
        n_w = words.shape[0]
        scores = jnp.where(nz,
                           jnp.int32(n_w) - jnp.arange(n_w, dtype=jnp.int32),
                           jnp.int32(0))
        k_eff = min(cap_words, n_w)   # static; top_k requires k <= length
        s, topi = jax.lax.top_k(scores, k_eff)
        keep = s > 0
        widx = jnp.where(keep, topi.astype(jnp.int32), -1)
        wvals = jnp.where(keep, words[jnp.maximum(widx, 0)], jnp.uint32(0))
        if k_eff < cap_words:
            widx = jnp.pad(widx, (0, cap_words - k_eff), constant_values=-1)
            wvals = jnp.pad(wvals, (0, cap_words - k_eff))
        return carry, (widx, wvals, jnp.sum(passes.astype(jnp.int32)),
                       jnp.sum(nz.astype(jnp.int32)))

    _, (widx, wvals, cand_counts, word_counts) = \
        jax.lax.scan(one, None, coords)
    return widx, wvals, cand_counts, word_counts


@functools.partial(jax.jit, static_argnames=("tile", "out_cap"))
def compact_words(widx, wvals, tile: int, out_cap: int):
    """(K, cap_words) per-tile word indices/values -> ONE flat exactly-sized
    pair of arrays (packed = t * tile^2/32 + widx, -1 tail padding)."""
    K = widx.shape[0]
    wpt = tile * tile // 32
    assert K * wpt <= 2**31 - 1, "packed word index would overflow int32"
    t_ids = jnp.arange(K, dtype=jnp.int32)[:, None]
    packed = jnp.where(widx >= 0, t_ids * wpt + widx, -1).reshape(-1)
    vals = wvals.reshape(-1)
    pos = jnp.nonzero(packed >= 0, size=out_cap, fill_value=-1)[0]
    safe = jnp.maximum(pos, 0)
    return (jnp.where(pos >= 0, packed[safe], -1),
            jnp.where(pos >= 0, vals[safe], jnp.uint32(0)))


def sweep_compact_words(planes, thr, coords, tile: int, cap_words: int,
                        out_cap: int):
    """sweep_words + compact_words: all K tiles' nonzero mask words leave
    the device as one exactly-sized (packed int32, value uint32) pair.

    Returns (packed (out_cap,) int32, vals (out_cap,) uint32,
             cand_counts (K,) int32, word_counts (K,) int32)."""
    widx, wvals, cand_counts, word_counts = sweep_words(
        planes, thr, coords, tile, cap_words)
    packed, vals = compact_words(widx, wvals, tile, out_cap)
    return packed, vals, cand_counts, word_counts


def _group_count_fn(tile: int, g: int):
    """(tile, tile) bool -> (tile, tile//g) float32 per-(row, g-column-
    group) survivor counts as ONE exact f32 matmul (counts <= g <= 32
    < 2^24). Operand generated from iota — no HLO literals."""
    ng = tile // g

    def counts(passes):
        cc = jnp.arange(tile, dtype=jnp.int32)
        w = jnp.arange(ng, dtype=jnp.int32)
        onehot = (cc[:, None] // g == w[None, :]).astype(jnp.float32)
        # DEFAULT precision is exact here even as TF32 or bf16: operands
        # are 0/1 and the float32 sums stay <= g
        return jax.lax.dot_general(
            passes.astype(jnp.float32), onehot,
            (((1,), (0,)), ((), ())),
            precision=jax.lax.Precision.DEFAULT,
            preferred_element_type=jnp.float32)          # (tile, ng)
    return counts


def _pack_words_fns(tile: int):
    """Mask (tile, tile) bool -> (tile*tile//32,) uint32 packer. Matmul
    path when tile % 32 == 0 (two exact f32 matmuls; each word column sums
    <= 16 bits < 2^16), elementwise shift-sum otherwise."""
    if tile % 32 == 0:
        wpt_row = tile // 32

        def masks():
            # generated from iota (NOT literal arrays): a (tile, tile/32)
            # f32 literal pair would put ~0.5 MB each into the HLO
            cc = jnp.arange(tile, dtype=jnp.int32)
            w = jnp.arange(wpt_row, dtype=jnp.int32)
            onehot = (cc[:, None] // 32 == w[None, :]).astype(jnp.float32)
            bit = cc % 32
            lo_w = jnp.where(bit < 16, (1 << jnp.minimum(bit, 15))
                             .astype(jnp.float32), 0.0)
            hi_w = jnp.where(bit >= 16, (1 << jnp.maximum(bit - 16, 0))
                             .astype(jnp.float32), 0.0)
            return onehot * lo_w[:, None], onehot * hi_w[:, None]

        def pack(passes):
            m_lo, m_hi = masks()
            pf = passes.astype(jnp.float32)
            # DEFAULT precision is exact here even as TF32 or bf16:
            # operands are 0/1 and powers of two up to 2^15, and each
            # float32 sum stays below 2^16
            dims = (((1,), (0,)), ((), ()))
            lo = jax.lax.dot_general(pf, m_lo, dims,
                                     precision=jax.lax.Precision.DEFAULT,
                                     preferred_element_type=jnp.float32)
            hi = jax.lax.dot_general(pf, m_hi, dims,
                                     precision=jax.lax.Precision.DEFAULT,
                                     preferred_element_type=jnp.float32)
            return ((hi.astype(jnp.uint32) << 16)
                    | lo.astype(jnp.uint32)).reshape(-1)
        return pack

    lane = jnp.arange(32, dtype=jnp.uint32)

    def pack(passes):
        grouped = passes.reshape(-1, 32).astype(jnp.uint32)
        return jnp.sum(grouped << lane, axis=1).astype(jnp.uint32)
    return pack


def _count_le(a, q):
    """Per-query count of elements of SORTED a (n,) that are <= q —
    identical to jnp.searchsorted(a, q, side='right') but as an UNROLLED
    branchless binary search (log2(n) gather+select steps on registers).
    jnp.searchsorted's lowering measured ~50 us per scan step at n=2048
    inside the fused kernel; this form is ~5 us."""
    n = a.shape[0]
    pos = jnp.zeros(q.shape, jnp.int32)
    # first step = smallest pow2 >= n so pos can reach n itself (the
    # side='right' result range is [0, n]; halving before the descent made
    # n unreachable for pow2 n and always returned 0 for n=1)
    step = 1
    while step < n:
        step <<= 1
    while step:
        cand = pos + step
        ok = (cand <= n) & (a[jnp.minimum(cand, n) - 1] <= q)
        pos = jnp.where(ok, cand, pos)
        step >>= 1
    return pos


@functools.partial(jax.jit,
                   static_argnames=("tile", "L", "cap_c", "gate"))
def sweep_extract_fused_ij(planes_i, thr_i_all, planes_j, thr_j_all,
                           coords, bases, tile: int, L: int, cap_c: int,
                           gate: bool = False):
    """SINGLE-PASS sweep + extraction + exact finalize partials (the
    round-3 engine) over a RECTANGULAR tile space: row tiles come from
    planes_i, column tiles from planes_j (pass the same array twice for
    the symmetric device-resident case — no copy is made). The split
    operands are what the beyond-HBM streaming engine needs: shard rows
    staged once per shard, column windows streamed past them, no
    per-window concatenation.

    One scan over tile coordinates that fuses

      1. the L(L+1)/2 int8 plane matmuls + float32 threshold (the sweep),
      2. survivor compaction by DIRECT RANK LOOKUP: per-(row, 32-column-
         group) survivor counts come from one exact f32 matmul; the
         k-th survivor's (row, group, bit) is then found with a cumsum
         over tile rows + tiny per-candidate cumsums — no sort, no
         top_k, no bit-packing pass,
      3. exact per-candidate limb-pair dot partials, recomputed in-kernel
         from the ALREADY-SLICED tile operands (the round-2 engine paid a
         third pass over the planes + an extra dispatch per chunk for
         this — ops.pairwise.exact_dots_device gathers over all N rows).

    The host turns partials into exact int64 dots with an O(L^2) weighted
    combine (:func:`combine_plane_partials`) — it never touches vectors.

    Replaces (for the device-resident engine) the reference's chunked
    compute + threshold loop, pairwise_comp_optimized.cpp:949-990.

    Args:
      planes_i/planes_j: (P, Ni/Nj, d) int8 Karatsuba planes; first L are
        the limbs. Row tiles slice planes_i, column tiles planes_j.
      thr_i_all/thr_j_all: (Ni,)/(Nj,) float32 squared-norm thresholds
        (+inf padding rows).
      coords: (K, 3) int32 (row_tile into planes_i, col_tile into
        planes_j, valid).
      bases: (K, 2) int32 per-tile (row_base, col_base) GLOBAL element
        offsets. Used to mask SELF-pairs (global row == global column)
        out of the survivor set: the engine emits them directly from the
        exact self dots instead, which keeps diagonal tiles at ordinary
        density (every diagonal tile would otherwise carry >= tile
        guaranteed survivors and overflow any reasonable capacity floor).
      cap_c: static per-tile candidate capacity.

    Returns per tile (scan-stacked):
      cand_idx (K, cap_c) int32 — in-tile flat indices i*tile+j, ascending,
        -1 padding; TRUNCATED to the first cap_c when the tile overflows
        (the counts say so; the engine retries those tiles at exact caps).
      partials (K, cap_c, L(L+1)/2) int32 — exact limb-pair partials
        (diagonal terms first, then symmetrized cross terms, the
        :func:`combine_plane_partials` order).
      cand_counts (K,) int32 — TRUE survivor count (authoritative).
    """
    P, _, d = planes_i.shape
    PL = num_planes(L)
    g = 32 if tile % 32 == 0 else tile     # column-group width
    ng = tile // g
    gcount = _group_count_fn(tile, g)
    pack = _pack_words_fns(tile) if g == 32 else None
    gi = jnp.arange(g, dtype=jnp.int32)

    def one(carry, rcb):
        rc, tb = rcb
        r, c, valid = rc[0], rc[1], rc[2]
        vi = jax.lax.dynamic_slice(planes_i, (0, r * tile, 0), (P, tile, d))
        vj = jax.lax.dynamic_slice(planes_j, (0, c * tile, 0), (P, tile, d))
        thr_i = jax.lax.dynamic_slice(thr_i_all, (r * tile,), (tile,))
        thr_j = jax.lax.dynamic_slice(thr_j_all, (c * tile,), (tile,))
        approx = approx_dot_f32(vi, vj)
        ti_g = tb[0] + jax.lax.iota(jnp.int32, tile)      # global rows
        tj_g = tb[1] + jax.lax.iota(jnp.int32, tile)      # global cols
        passes = (approx / np.float32(d) >
                  0.05 * (thr_i[:, None] + thr_j[None, :]) * SLACK_REL
                  - SLACK_ABS) & (valid > 0) \
            & (ti_g[:, None] != tj_g[None, :])            # self-pairs out

        # survivor counts come free off the sweep (one tiny extra
        # matmul, ~0.5% of the sweep FLOPs at tile=2048); they gate the
        # whole selection + partials stages below
        wcounts = gcount(passes).astype(jnp.int32)         # (tile, ng)
        row_counts = jnp.sum(wcounts, axis=1)              # (tile,)
        cand_count = jnp.sum(row_counts)

        def hot(_):
            # ---- direct rank lookup: the k-th survivor's (row, group,
            # bit). Every step is either a matmul over the mask or a small
            # lookup; it avoids the two costly forms (jnp.searchsorted's
            # lowering, and a scattered (cap_c, 32) element gather from
            # the tile^2 mask).
            cum_rows = jnp.cumsum(row_counts)
            starts = cum_rows - row_counts
            j = jnp.arange(cap_c, dtype=jnp.int32)
            row_s = jnp.minimum(_count_le(cum_rows, j), tile - 1)
            local = j - starts[row_s]
            wrow = wcounts[row_s]                          # (cap_c, ng)
            cumw = jnp.cumsum(wrow, axis=1)
            grp = jnp.sum((cumw <= local[:, None]).astype(jnp.int32),
                          axis=1)
            grp_s = jnp.minimum(grp, ng - 1)
            before = jnp.where(
                grp_s > 0,
                jnp.take_along_axis(cumw,
                                    jnp.maximum(grp_s - 1, 0)[:, None],
                                    axis=1)[:, 0], 0)
            q2 = local - before
            base = row_s * tile + grp_s * g
            if pack is not None:
                # one uint32 word per candidate from the matmul-packed mask
                # (128 KB), then a 32-step bit-rank
                words = pack(passes)                       # (tile*ng,)
                w = words[row_s * ng + grp_s]              # (cap_c,)
                cum = jnp.zeros_like(q2)
                bit = jnp.zeros_like(q2)
                for n in range(32):
                    b_n = ((w >> jnp.uint32(n))
                           & jnp.uint32(1)).astype(jnp.int32)
                    cum = cum + b_n
                    bit = bit + (cum <= q2).astype(jnp.int32)
            else:
                flat = passes.reshape(-1).astype(jnp.int32)
                seg = flat[base[:, None] + gi[None, :]]    # (cap_c, g)
                cumb = jnp.cumsum(seg, axis=1)
                bit = jnp.sum((cumb <= q2[:, None]).astype(jnp.int32),
                              axis=1)
            valid_c = j < cand_count
            cand = jnp.where(valid_c,
                             base + jnp.minimum(bit, g - 1),
                             -1)                           # (cap_c,)

            # ---- exact limb-pair partials for the selected candidates,
            # from the tile operands already on hand (first L planes = the
            # limbs). Per-limb row gathers + elementwise multiply-reduce:
            # the batched (cap_c, L, d) x (cap_c, L, d) dot_general lowers
            # to cap_c tiny matmuls; the explicit form is one elementwise
            # pass.
            ii = jnp.maximum(cand, 0) // tile
            jj = jnp.maximum(cand, 0) % tile
            xs = [vi[a][ii].astype(jnp.int32)
                  for a in range(L)]                       # (cap_c, d)
            ys = [vj[b][jj].astype(jnp.int32) for b in range(L)]
            cols = [jnp.sum(xs[a] * ys[a], axis=1) for a in range(L)]
            cols += [jnp.sum(xs[a] * ys[b] + xs[b] * ys[a], axis=1)
                     for a in range(L) for b in range(a + 1, L)]
            partials = jnp.stack(cols, axis=1)             # (cap_c, PL)
            return cand, jnp.where(valid_c[:, None], partials, 0)

        def cold(_):
            # + cand_count*0 makes the constants VARY over the shard_map
            # data axis like the hot branch's outputs do (cond requires
            # branch output types — including varying axes — to match)
            z = cand_count * 0
            return (jnp.full((cap_c,), -1, jnp.int32) + z,
                    jnp.zeros((cap_c, PL), jnp.int32) + z)

        # gate=True: candidate-free tiles skip selection + partials via an
        # HLO conditional (only the taken branch executes). At production
        # density with tile >= 2048 (~60 expected candidates per 4.2M-pair
        # tile) essentially every tile is hot and the cond only adds
        # work; it pays only for much smaller tiles or far sparser
        # thresholds. Off by default; opt in
        # for genuinely sparse tile grids via
        # matrix.compute.compute_pairwise_shard(gate=True) / the CLI's
        # --gate_sparse_tiles.
        if gate:
            cand, partials = jax.lax.cond(cand_count > 0, hot, cold, 0)
        else:
            cand, partials = hot(0)
        return carry, (cand, partials, cand_count)

    _, (cand_idx, partials, cand_counts) = \
        jax.lax.scan(one, None, (coords, bases))
    return cand_idx, partials, cand_counts


def sweep_extract_fused(planes, thr, coords, tile: int, L: int,
                        cap_c: int, gate: bool = False):
    """Symmetric (all-vs-all) wrapper of :func:`sweep_extract_fused_ij` —
    row and column tiles slice the same device-resident planes array,
    bases derived from the tile coordinates."""
    bases = coords[:, :2].astype(jnp.int32) * tile
    return sweep_extract_fused_ij(planes, thr, planes, thr, coords,
                                  bases, tile, L, cap_c, gate=gate)


@functools.partial(jax.jit, static_argnames=("tile", "out_cap"))
def compact_cands_combined(cand_counts, cand_idx, partials,
                           bases, tile: int, out_cap: int):
    """Single-buffer chunk compaction: everything the host needs from one
    fused chunk as ONE int32 array, so ONE device->host transfer moves it
    (each transfer carries a fixed latency).

    Valid entries form a PREFIX of each tile row (sweep_extract_fused's
    first-k selection packs them at the front), so the flatten is a
    cumsum + binary-search GATHER — O(out_cap log K) — instead of a
    top_k/sort over K*cap_c elements (at production sizes a ~100k-deep
    sort over 262k elements, which dominated the whole fused engine).

    Layout (all int32):
      [0,  K)                 cand_counts
      [K,  K+out_cap)         r_glob  (global row; -1 tail padding)
      [.., ..+out_cap)        c_glob  (global column)
      [.., ..+out_cap*PL)     partials, candidate-major (PL per candidate)

    bases: (K, 2) int32 — per-tile (row_base, col_base) GLOBAL element
    offsets (the caller's tile->global mapping, moved in-kernel so the
    host does zero index arithmetic).
    """
    K, cap_c = cand_idx.shape
    PL = partials.shape[2]
    # same int32 guard as compact_indices/compact_words: the cumsum below
    # is int32, so a K*cap_c total beyond 2^31 would wrap `ends` negative
    # and gather garbage with no error
    assert K * cap_c < (1 << 31), \
        "candidate total would overflow the int32 compaction cumsum"
    kept = jnp.sum((cand_idx >= 0).astype(jnp.int32), axis=1)   # (K,)
    # tiles that overflowed cap_c are dropped HERE (their counts in the
    # header route them to the engine's exact-capacity retry; their
    # truncated candidates must not be emitted)
    kept = jnp.where(cand_counts > cap_c, 0, kept)
    ends = jnp.cumsum(kept)
    starts = ends - kept
    total = ends[-1]
    i = jnp.arange(out_cap, dtype=jnp.int32)
    t_safe = jnp.minimum(_count_le(ends, i), K - 1)
    j = jnp.clip(i - starts[t_safe], 0, cap_c - 1)
    valid = i < total
    local = cand_idx[t_safe, j]
    r_glob = jnp.where(valid, bases[t_safe, 0] + local // tile, -1)
    c_glob = jnp.where(valid, bases[t_safe, 1] + local % tile, -1)
    parts = jnp.where(valid[:, None], partials[t_safe, j], 0)
    return jnp.concatenate([
        cand_counts.astype(jnp.int32), r_glob, c_glob, parts.reshape(-1)])


def split_combined(buf: np.ndarray, K: int, out_cap: int, PL: int):
    """Host-side view split of one compact_cands_combined buffer ->
    (cand_counts (K,), r_glob, c_glob, partials (n_valid, PL)) with
    padding rows removed."""
    cand_counts = buf[:K]
    r_glob = buf[K:K + out_cap]
    c_glob = buf[K + out_cap:K + 2 * out_cap]
    parts = buf[K + 2 * out_cap:].reshape(out_cap, PL)
    valid = r_glob >= 0
    return (cand_counts, r_glob[valid].astype(np.int64),
            c_glob[valid].astype(np.int64), parts[valid])


@functools.partial(jax.jit, static_argnames=("L",))
def plane_partial_dots(planes, r_idx, c_idx, L: int):
    """Exact per-candidate limb-pair dot partials, on device.

    For candidates (r, c): D[a, b, k] = dot(limb_a(V[r_k]), limb_b(V[c_k]))
    — int32-exact (|D| <= d * 64^2 << 2^31). The exact int64 dot is then the
    O(L^2) host combine sum_ab 2^(7(a+b)) D_ab, so the host never touches
    the vectors: finalize work drops from O(K*d) host FLOPs to O(K), at the
    cost of L(L+1)/2 extra int32 per candidate of D2H.

    planes: (P, Npad, d) int8 Karatsuba planes (first L are the limbs).
    Returns (L*(L+1)//2, K) int32: diagonal terms D_aa first, then the
    SYMMETRIZED cross terms D_ab + D_ba for a < b (|sum| <= 2^24).
    """
    limbs = planes[:L]
    x = jnp.transpose(limbs[:, r_idx, :], (1, 0, 2)).astype(jnp.int8)
    y = jnp.transpose(limbs[:, c_idx, :], (1, 0, 2)).astype(jnp.int8)
    # batched tiny matmul on the reduction axis d: (K, L, d) x (K, L, d)
    D = jax.lax.dot_general(
        x, y, dimension_numbers=(((2,), (2,)), ((0,), (0,))),
        preferred_element_type=jnp.int32)          # (K, L, L)
    diag = jnp.stack([D[:, a, a] for a in range(L)])
    cross = [D[:, a, b] + D[:, b, a] for a in range(L)
             for b in range(a + 1, L)]
    if cross:
        return jnp.concatenate([diag, jnp.stack(cross)], axis=0)
    return diag


def combine_plane_partials(partials: np.ndarray, L: int) -> np.ndarray:
    """(L(L+1)/2, K) int32 partials -> (K,) exact int64 dots:
    dot = sum_a 2^(14a) D_aa + sum_{a<b} 2^(7(a+b)) (D_ab + D_ba).

    Exactness requires |dot| < 2^63 — i.e. d * max_abs^2 < 2^62, which
    :func:`check_exact_dot_range` enforces at engine/index entry (the
    combine itself cannot see max_abs and would wrap silently)."""
    partials = partials.astype(np.int64)
    w = [1 << (14 * a) for a in range(L)]
    w += [1 << (7 * (a + b)) for a in range(L) for b in range(a + 1, L)]
    return np.asarray(w, dtype=np.int64) @ partials


def exact_dots_device(planes, L: int, rows: np.ndarray, cols: np.ndarray,
                      chunk: int = 65536) -> np.ndarray:
    """Device-side exact dot recomputation for candidate coordinate arrays
    (the alternative to :func:`exact_dots_host` — use when the host is
    slow/small relative to the device->host link; the host path
    moves 4 B/candidate D2H + O(K*d) host FLOPs, this path 4+4L(L+1)/2*4
    B/candidate and O(K) host FLOPs). Calls are padded to at most TWO
    static shapes (a small one and `chunk`) — few compiled programs per
    (planes, L)."""
    K = len(rows)
    small = 4096
    out = np.empty(K, dtype=np.int64)
    for s in range(0, K, chunk):
        e = min(s + chunk, K)
        n = e - s
        size = small if n <= small else chunk
        r = np.zeros(size, dtype=np.int32)
        c = np.zeros(size, dtype=np.int32)
        r[:n] = rows[s:e]
        c[:n] = cols[s:e]
        parts = np.asarray(plane_partial_dots(planes, jnp.asarray(r),
                                              jnp.asarray(c), L))
        out[s:e] = combine_plane_partials(parts[:, :n], L)
    return out


def exact_dots_host(V: np.ndarray, rows: np.ndarray, cols: np.ndarray,
                    max_abs: int, chunk: int | None = None) -> np.ndarray:
    """Exact int64 dot products of V[rows] . V[cols] on host.

    float64 accumulation is exact while every partial sum stays an integer
    below 2^53 (d * max_abs^2 — true for any real sketch db, components are
    bounded by hash-set sizes); int64 accumulation covers the rest. Chunked
    so the two gathered float64 copies stay near 256 MB regardless of d."""
    d = V.shape[1]
    if chunk is None:
        chunk = max(1024, (256 << 20) // (16 * d))
    f64_ok = d * (max_abs ** 2) < (1 << 53)
    assert f64_ok or d * (max_abs ** 2) < (1 << 62), "dot would overflow int64"
    out = np.empty(len(rows), dtype=np.int64)
    dt = np.float64 if f64_ok else np.int64
    for s in range(0, len(rows), chunk):
        e = min(s + chunk, len(rows))
        gi = V[rows[s:e]].astype(dt)
        gj = V[cols[s:e]].astype(dt)
        out[s:e] = np.einsum("kd,kd->k", gi, gj).astype(np.int64)
    return out


def exact_filter_int32(dots: np.ndarray, thr: np.ndarray, d: int) -> np.ndarray:
    """Reference int32 retention: (dot / d) > 0.05*(ni+nj) with C++ int64
    truncating division (pairwise_comp_optimized.cpp:139-141)."""
    q = np.where(dots >= 0, dots // d, -((-dots) // d))
    return q.astype(np.float64) > thr


def exact_filter_int16(dots: np.ndarray, thr: np.ndarray, d: int) -> np.ndarray:
    """Reference int16 retention: double division
    (pairwise_comp_optimized_16bits.cpp:211-218)."""
    return dots.astype(np.float64) / d > thr
