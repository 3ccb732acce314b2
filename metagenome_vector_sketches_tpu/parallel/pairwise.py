"""Sharded all-vs-all pairwise sweep.

Each device owns a row block of the (limb-decomposed) vector matrix; the
column side streams through the ring via jax.lax.all_gather over the mesh
axis. The thresholded survivor mask / quantized
Jaccard tiles come back row-sharded, so downstream host finalization and
shard writing stay per-host exactly like the single-chip engine.
"""

from __future__ import annotations

import functools  # noqa: F401  (lru_cache for the jitted topk builder)

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from jax import shard_map

from .mesh import DATA_AXIS


def sharded_pairwise_counts(mesh, v_limbs, thr, d: int):
    """One full sharded sweep: per-row SWEEP-candidate counts under the
    engine's widened retention threshold (SLACK_REL/SLACK_ABS — a certified
    superset of exact retention), the statistic used for capacity planning
    and the multi-chip validation step.

    Args:
      mesh: 1-D Mesh over axis 'data'.
      v_limbs: (L, N, d) int8 balanced limbs (ops.pairwise.decompose_limbs)
        — row-sharded on axis 1 (N divisible by mesh size). Limbs, not
        planes: the Karatsuba sum planes are rebuilt locally AFTER the
        gather, so the all_gather moves L/P = 2/3 of the bytes.
      thr: (N,) float32 squared norms — row-sharded.
      d: dimension.

    Returns:
      (N,) int32 per-row survivor counts, row-sharded.
    """
    from ..ops.pairwise import (approx_dot_f32, karatsuba_planes,
                                SLACK_REL, SLACK_ABS)

    def step(v_local, thr_local):
        # gather the full column side (limbs only), extend locally
        v_all = jax.lax.all_gather(v_local, DATA_AXIS, axis=1, tiled=True)
        thr_all = jax.lax.all_gather(thr_local, DATA_AXIS, axis=0, tiled=True)
        approx = approx_dot_f32(karatsuba_planes(v_local),
                                karatsuba_planes(v_all))
        # SAME widened comparison as the engine sweep (ops/pairwise.py
        # sweep kernels): this statistic sizes engine capacities, so it
        # must count what the sweep counts — a certified superset of the
        # exact retention — not a raw-f32 approximation that can under-
        # count a borderline pair the sweep keeps.
        passes = (approx / np.float32(d) >
                  0.05 * (thr_local[:, None] + thr_all[None, :]) * SLACK_REL
                  - SLACK_ABS)
        return jnp.sum(passes.astype(jnp.int32), axis=1)

    fn = shard_map(step, mesh=mesh,
                   in_specs=(P(None, DATA_AXIS, None), P(DATA_AXIS)),
                   out_specs=P(DATA_AXIS))
    return jax.jit(fn)(v_limbs, thr)


@functools.lru_cache(maxsize=None)
def _topk_fn(mesh, k: int, n_valid, recall_target: float = 1.0,
             with_ids: bool = False):
    def step(q, v_local, ids_local=None):
        scores = jax.lax.dot_general(
            q, v_local, dimension_numbers=(((1,), (1,)), ((), ())),
            precision=jax.lax.Precision.HIGHEST,
            preferred_element_type=jnp.float32)
        if with_ids:
            # explicit per-row global ids (-1 = pad): arbitrary — e.g.
            # per-process — row layouts; pads lose to any real neighbor
            scores = jnp.where(ids_local[None, :] >= 0, scores, -jnp.inf)
        else:
            base = jax.lax.axis_index(DATA_AXIS) * v_local.shape[0]
            if n_valid is not None:
                # mesh-padding rows must lose to ANY real neighbor,
                # including negative-inner-product ones (a zero pad row
                # scores 0, which would displace genuine anti-correlated
                # neighbors from top-k)
                idx = base + jnp.arange(v_local.shape[0], dtype=jnp.int32)
                scores = jnp.where(idx[None, :] < n_valid, scores,
                                   -jnp.inf)
        kk = min(k, v_local.shape[0])
        if recall_target < 1.0:
            # approx local selection; the cross-device
            # merge below stays an exact re-top-k over the local pools
            d_loc, i_loc = jax.lax.approx_max_k(
                scores, kk, recall_target=recall_target,
                aggregate_to_topk=True)
        else:
            d_loc, i_loc = jax.lax.top_k(scores, kk)
        if with_ids:
            i_loc = ids_local[i_loc]
        else:
            i_loc = i_loc + base
        if kk < k:
            pad_d = jnp.full((q.shape[0], k - kk), -jnp.inf, jnp.float32)
            pad_i = jnp.full((q.shape[0], k - kk), -1, jnp.int32)
            d_loc = jnp.concatenate([d_loc, pad_d], axis=1)
            i_loc = jnp.concatenate([i_loc, pad_i], axis=1)
        # merge across devices: gather the n_dev*k candidates, re-top-k
        d_all = jax.lax.all_gather(d_loc, DATA_AXIS, axis=1, tiled=True)
        i_all = jax.lax.all_gather(i_loc, DATA_AXIS, axis=1, tiled=True)
        d_fin, sel = jax.lax.top_k(d_all, k)
        i_fin = jnp.take_along_axis(i_all, sel, axis=1)
        return d_fin, i_fin

    in_specs = (P(), P(DATA_AXIS, None))
    if with_ids:
        in_specs = in_specs + (P(DATA_AXIS),)
    fn = shard_map(step, mesh=mesh,
                   in_specs=in_specs,
                   out_specs=(P(), P()),
                   check_vma=False)  # outputs identical on all devices post-gather
    return jax.jit(fn)


def distributed_topk(mesh, queries, v_norm, k: int, n_valid: int | None = None,
                     recall_target: float = 1.0, row_ids=None):
    """Distributed flat-IP top-k: database rows sharded across the mesh,
    queries replicated; local fused dot+top_k then an all_gather merge.

    Args:
      queries: (B, d) float32 replicated.
      v_norm: (N, d) float32 L2-normalized database, row-sharded.
      k: static top-k (<= N / mesh size for the local stage).
      n_valid: true row count when v_norm carries mesh-padding rows; padded
        rows score -inf so they never displace real (even negative-score)
        neighbors.
      recall_target: < 1.0 switches the per-device LOCAL selection to
        jax.lax.approx_max_k (the cross-device merge stays exact).
      row_ids: optional (N,) int32 row-sharded EXPLICIT global ids (-1 =
        pad row); overrides n_valid for arbitrary — e.g. per-process —
        row layouts (the emitted I are these ids).

    Returns:
      (D (B, k) float32, I (B, k) int32 global row indices), replicated.
      Slots beyond the real matches come back with score -inf.
    """
    if row_ids is not None:
        return _topk_fn(mesh, k, None, recall_target,
                        with_ids=True)(queries, v_norm, row_ids)
    return _topk_fn(mesh, k, n_valid, recall_target)(queries, v_norm)
