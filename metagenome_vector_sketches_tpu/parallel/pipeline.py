"""The fused end-to-end pipeline step — the framework's 'training step'
equivalent: sketch (projection) -> pairwise threshold sweep -> top-k search,
as ONE jitted program over a device mesh.

Shardings: the accession batch is data-parallel (dp) across the mesh;
inside the pairwise/top-k stages each device owns its row block and the
column side is all-gathered; top-k candidates merge with a
gather + re-top-k. Used by __graft_entry__.dryrun_multichip and the
multi-chip benchmarks.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from jax import shard_map

from .mesh import DATA_AXIS
from ..ops.splitmix import splitmix64_u32


def _project(hash_hi, hash_lo, valid_count, d: int):
    """Inline (shard_map-safe) projection: identical math to
    ops.projection.project_device_batch."""
    B, H = hash_hi.shape
    num_blocks = (d + 63) // 64
    mask = (jax.lax.broadcasted_iota(jnp.int32, (B, H), 1)
            < valid_count[:, None])
    lane = jnp.arange(32, dtype=jnp.uint32)

    def block(carry, b):
        blo = b.astype(jnp.uint32) * jnp.uint32(64)
        lo = hash_lo + blo
        hi = hash_hi + (lo < hash_lo).astype(jnp.uint32)
        rhi, rlo = splitmix64_u32(hi, lo)
        bits_lo = (rlo[:, :, None] >> lane) & jnp.uint32(1)
        bits_hi = (rhi[:, :, None] >> lane) & jnp.uint32(1)
        m = mask[:, :, None]
        s_lo = jnp.sum(jnp.where(m, bits_lo, 0).astype(jnp.int32), axis=1)
        s_hi = jnp.sum(jnp.where(m, bits_hi, 0).astype(jnp.int32), axis=1)
        return carry, valid_count[:, None] - 2 * jnp.concatenate([s_lo, s_hi], -1)

    _, blocks = jax.lax.scan(block, None, jnp.arange(num_blocks, dtype=jnp.int32))
    return jnp.transpose(blocks, (1, 0, 2)).reshape(B, num_blocks * 64)[:, :d]


def make_pipeline_step(mesh, d: int, L: int, k: int):
    """Build the jitted full pipeline step over `mesh`.

    step(hash_hi, hash_lo, counts) with the accession batch row-sharded:
      1. project hash sets -> int32 sketch vectors             (dp)
      2. limb-decompose + all-gather columns, threshold sweep  (dp)
      3. L2-normalize, distributed top-k with gather merge     (dp)
    Returns (survivor_counts (B,), topk_idx (B, k), topk_scores (B, k)).
    """

    def step(hash_hi, hash_lo, counts):
        vecs = _project(hash_hi, hash_lo, counts, d)               # (b, d) local
        # exact squared norms as the |set| estimate
        norms_sq = jnp.sum((vecs.astype(jnp.float32) / np.float32(np.sqrt(d))) ** 2,
                           axis=1)
        # balanced base-128 limbs; gather limbs (2/3 the bytes of
        # planes), extend to Karatsuba planes locally, weighted sweep
        from ..ops.pairwise import (approx_dot_f32, decompose_limbs,
                                    karatsuba_planes)
        limbs = decompose_limbs.__wrapped__(vecs, L)             # (L, b, d)

        v_all = jax.lax.all_gather(limbs, DATA_AXIS, axis=1, tiled=True)
        thr_all = jax.lax.all_gather(norms_sq, DATA_AXIS, axis=0, tiled=True)
        approx = approx_dot_f32(karatsuba_planes(limbs),
                                karatsuba_planes(v_all))
        # RAW retention threshold, deliberately NOT the engine sweep's
        # SLACK-widened one (parallel.pairwise.sharded_pairwise_counts):
        # this is a retention statistic for the demo/dryrun step, and at
        # toy scale SLACK_ABS (=16) would swamp the tiny norms and mark
        # every pair a survivor, hiding the thresholding behavior the
        # dryrun output is meant to show
        passes = approx / np.float32(d) > 0.05 * (norms_sq[:, None] + thr_all[None, :])
        survivors = jnp.sum(passes.astype(jnp.int32), axis=1)       # (b,) local

        # distributed flat-IP top-k of each sketch against the whole batch
        vf = vecs.astype(jnp.float32)
        inv = jax.lax.rsqrt(jnp.maximum(jnp.sum(vf * vf, axis=1, keepdims=True), 1e-30))
        q = vf * inv
        v_norm_all = jax.lax.all_gather(q, DATA_AXIS, axis=0, tiled=True)
        scores = jax.lax.dot_general(
            q, v_norm_all, dimension_numbers=(((1,), (1,)), ((), ())),
            precision=jax.lax.Precision.HIGHEST,
            preferred_element_type=jnp.float32)
        kk = min(k, scores.shape[1])
        topd, topi = jax.lax.top_k(scores, kk)
        return survivors, topi.astype(jnp.int32), topd

    sharded = shard_map(step, mesh=mesh,
                        in_specs=(P(DATA_AXIS), P(DATA_AXIS), P(DATA_AXIS)),
                        out_specs=(P(DATA_AXIS), P(DATA_AXIS), P(DATA_AXIS)))
    return jax.jit(sharded)
