"""Seeded +-1 random projection of FracMinHash sets into Z^d.

Math (bit-exact with reference src/random_projection.cpp:9-26): for each hash
``h`` in a set and each 64-lane block start ``i in {0, 64, ... < d}``,
``x = splitmix64(h + i)``; lane ``n`` of the block contributes
``1 - 2*((x >> n) & 1)`` to ``vec[i + n]``. The result is an int32 count
vector; its accumulation is order-independent, so any batching/sharding of the
hash set is exact.

Two execution paths, tested equal:

- :func:`project_host` — numpy uint64 + unpackbits. Used for bit-match tests
  and as a CPU fallback.
- :func:`project_device_batch` — the device path. Hash sets are padded into a
  ``(B, H)`` bucket; splitmix64 runs on (hi, lo) uint32 pairs; the +-1 sum
  over hashes for lane ``n`` equals ``count_valid - 2 * sum(bit_n)``. The
  per-lane bit sums use SWAR vertical counters (:func:`_bit_lane_sums`):
  chunks of 15 words accumulate 8 lanes per 4-bit field of one uint32
  accumulator — ~5x fewer vector ops and ~8x less intermediate traffic
  than extracting each lane to its own int32.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from .splitmix import splitmix64_np, splitmix64_u32, split_u64

from ..utils import compilecache
compilecache.ensure()

_U64 = np.uint64


# ---------------------------------------------------------------------------
# Host path
# ---------------------------------------------------------------------------

def project_host(hashes, d: int, hash_chunk: int = 65536) -> np.ndarray:
    """Project one hash set (iterable of uint64) into an int32 vector of dim d.

    Bit-exact with reference transform_set_into_vector
    (src/random_projection.cpp:9-26). Chunked over hashes to bound memory.
    """
    hashes = np.fromiter((int(h) for h in hashes), dtype=np.uint64) \
        if not isinstance(hashes, np.ndarray) else hashes.astype(np.uint64)
    num_blocks = (d + 63) // 64
    offsets = (np.arange(num_blocks, dtype=np.uint64) * _U64(64))
    bitsum = np.zeros((num_blocks, 64), dtype=np.int64)
    n = hashes.shape[0]
    for s in range(0, n, hash_chunk):
        hs = hashes[s:s + hash_chunk]
        x = splitmix64_np(hs[:, None] + offsets[None, :])      # (h, B)
        bytes_ = x.view(np.uint8).reshape(hs.shape[0], num_blocks, 8)
        bits = np.unpackbits(bytes_, axis=-1, bitorder="little")  # (h, B, 64)
        bitsum += bits.sum(axis=0, dtype=np.int64)
    vec = (np.int64(n) - 2 * bitsum).reshape(-1)[:d]
    return vec.astype(np.int32)


def _as_u64_array(hs) -> np.ndarray:
    """Fast cast for the ingest hot path: typed arrays pass through; only
    python sets/iterables take the per-element route. Accumulation is
    order-independent, so no sort is needed."""
    if isinstance(hs, np.ndarray):
        return np.ascontiguousarray(hs, dtype=np.uint64)
    return np.fromiter((int(h) for h in hs), dtype=np.uint64)


def project_host_many(hash_sets, d: int) -> np.ndarray:
    """Project a list of hash sets -> (N, d) int32 matrix (host path)."""
    out = np.zeros((len(hash_sets), d), dtype=np.int32)
    for i, hs in enumerate(hash_sets):
        out[i] = project_host(_as_u64_array(hs), d)
    return out


# ---------------------------------------------------------------------------
# Device path
# ---------------------------------------------------------------------------

def _bit_lane_sums(w, nc: int):
    """Per-lane bit sums of (B, nc*15) uint32 words -> (B, 32) int32.

    SWAR vertical counters: within a chunk of 15 words, ``(w >> k) & 0x11111111``
    drops lane k+4j into 4-bit field j of one accumulator word; 15 single-bit
    adds cannot carry across fields. Fields are widened and summed across
    chunks afterwards (nc * 8 unpack ops amortized over 15 words each).
    """
    B = w.shape[0]
    wc = w.reshape(B, nc, 15)
    mask = jnp.uint32(0x11111111)
    js = (jnp.arange(8, dtype=jnp.uint32) * jnp.uint32(4))
    per_k = []
    for k in range(4):
        acc4 = jnp.sum((wc >> jnp.uint32(k)) & mask, axis=2)       # (B, nc)
        fields = (acc4[:, :, None] >> js) & jnp.uint32(0xF)        # (B, nc, 8)
        per_k.append(jnp.sum(fields.astype(jnp.int32), axis=1))    # (B, 8)
    # lane n = 4j + k  ->  stack k last, j-major reshape restores lane order
    return jnp.stack(per_k, axis=2).reshape(B, 32)


@functools.partial(jax.jit, static_argnames=("d",))
def project_device_batch(hash_hi, hash_lo, valid_count, d: int):
    """Project a padded batch of hash sets on the device.

    Args:
      hash_hi, hash_lo: (B, H) uint32 — hash values split into 32-bit halves.
        Padding entries must be ZERO. Rather than masking the padded slots
        (a (B,H,32) select per block), we sum over ALL slots and subtract the
        deterministic contribution of the zero hash: every padded slot
        contributes splitmix64(0 + 64b)'s bits, a per-(block, lane) constant.
      valid_count: (B,) int32 — number of real hashes per set.
      d: static output dimension.

    Returns:
      (B, d) int32 sketch vectors, bit-exact with :func:`project_host`.
    """
    B, H = hash_hi.shape
    num_blocks = (d + 63) // 64
    lane_shift = jnp.arange(32, dtype=jnp.uint32)

    # pad the hash slots to a multiple of the SWAR chunk (15 words); the
    # extra zero-hash slots fold into the same padded-slot correction below
    nc = (H + 14) // 15
    Hp = nc * 15
    if Hp != H:
        pad = ((0, 0), (0, Hp - H))
        hash_hi = jnp.pad(hash_hi, pad)
        hash_lo = jnp.pad(hash_lo, pad)

    # padded-slot (zero-hash) bit constants: (num_blocks, 64) int32
    zoff = jnp.arange(num_blocks, dtype=jnp.uint32) * jnp.uint32(64)
    zhi, zlo = splitmix64_u32(jnp.zeros_like(zoff), zoff)
    zbits = jnp.concatenate(
        [((zlo[:, None] >> lane_shift) & jnp.uint32(1)).astype(jnp.int32),
         ((zhi[:, None] >> lane_shift) & jnp.uint32(1)).astype(jnp.int32)],
        axis=-1)
    num_pad = (jnp.int32(Hp) - valid_count)[:, None]      # (B, 1)

    def one_block(b):
        # x = hash + 64*b  (the += GOLDEN lives inside splitmix64_u32)
        blo = (b.astype(jnp.uint32) * jnp.uint32(64))
        lo = hash_lo + blo
        hi = hash_hi + (lo < hash_lo).astype(jnp.uint32)
        rhi, rlo = splitmix64_u32(hi, lo)
        # lanes 0..31 from lo word, 32..63 from hi word; sum over ALL slots
        s_lo = _bit_lane_sums(rlo, nc)
        s_hi = _bit_lane_sums(rhi, nc)
        bitsum = jnp.concatenate([s_lo, s_hi], axis=-1) - num_pad * zbits[b]
        return valid_count[:, None] - 2 * bitsum

    # scan over GROUPS of blocks with a static unroll: one block per step
    # leaves little independent work per step, while fully vectorizing all
    # blocks multiplies peak memory by num_blocks; 4 per step sits between
    unroll = 4
    while num_blocks % unroll:
        unroll //= 2
    groups = jnp.arange(num_blocks, dtype=jnp.int32).reshape(-1, unroll)

    def block_group(carry, bs):
        return carry, jnp.stack([one_block(bs[u]) for u in range(unroll)])

    _, blocks = jax.lax.scan(block_group, None, groups)
    # blocks: (num_blocks/u, u, B, 64) -> (B, num_blocks*64) -> trim to d
    vecs = jnp.transpose(blocks.reshape(num_blocks, B, 64),
                         (1, 0, 2)).reshape(B, num_blocks * 64)
    return vecs[:, :d].astype(jnp.int32)


def _bucket_size(n: int, min_bucket: int = 256) -> int:
    """Round a hash-set size up to a power of two for bounded recompilation."""
    b = min_bucket
    while b < n:
        b *= 2
    return b


def project_device_many(hash_sets, d: int, batch_hint_elems: int = 1 << 24,
                        min_bucket: int = 256) -> np.ndarray:
    """Project many ragged hash sets on the device with power-of-two
    bucketing.

    Sets are grouped by padded bucket size (so jit compiles once per bucket
    size) and batched so each launch stays near ``batch_hint_elems`` padded
    hash slots.
    """
    N = len(hash_sets)
    out = np.zeros((N, d), dtype=np.int32)
    order = sorted(range(N), key=lambda i: len(hash_sets[i]))
    by_bucket: dict[int, list[int]] = {}
    for i in order:
        by_bucket.setdefault(_bucket_size(max(1, len(hash_sets[i])), min_bucket), []).append(i)
    for bucket, idxs in by_bucket.items():
        batch = max(1, batch_hint_elems // bucket)
        for s in range(0, len(idxs), batch):
            group = idxs[s:s + batch]
            B = len(group)
            arr = np.zeros((B, bucket), dtype=np.uint64)
            counts = np.zeros((B,), dtype=np.int32)
            for r, i in enumerate(group):
                hs = _as_u64_array(hash_sets[i])
                arr[r, :hs.shape[0]] = hs
                counts[r] = hs.shape[0]
            hi, lo = split_u64(arr)
            vecs = project_device_batch(jnp.asarray(hi), jnp.asarray(lo),
                                        jnp.asarray(counts), d)
            if counts.max(initial=0) <= 32767:
                # |v_j| <= #hashes, so the batch fits int16 losslessly:
                # halve the device->host volume (2.1 GB at N=262k)
                vecs = _downcast_i16(vecs)
            out[np.asarray(group)] = np.asarray(vecs)
    return out


_downcast_i16 = jax.jit(lambda v: v.astype(jnp.int16))
