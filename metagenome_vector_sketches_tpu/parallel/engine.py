"""Mesh-sharded pairwise-engine device ops.

The reference parallelizes one matrix shard only within a CPU socket
(OpenMP); its cross-machine story is one-shard-per-job (SURVEY.md §2.3).
Here ONE shard's whole tile grid is data-parallel over a jax.sharding.Mesh:
the Karatsuba planes and thresholds are replicated across the mesh, the tile
COORDINATE axis is sharded, and each device runs the same fused
sweep/extract programs (ops.pairwise) on its own subset of tiles under
shard_map — no collectives in the hot loop at all; the interconnect is
only touched by the one-time replication broadcast.

:class:`MeshSweepOps` exposes the three device calls the engine makes
(counts sweep, bitmap extraction, sparse compaction) with host-side results
in the exact single-device layout, so matrix.compute's extraction, exact
host finalize, and shard writer are device-count agnostic. With this, one
`shard_K/` folder (pairwise_comp_optimized.cpp:938-990) is produced by
every device of the mesh instead of leaving n-1 devices idle.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import NamedSharding, PartitionSpec as P

from .mesh import DATA_AXIS
from ..ops import pairwise as pw


@functools.lru_cache(maxsize=None)
def _counts_fn(mesh, tile: int):
    def local(planes, thr, coords):
        return pw.sweep_counts_impl(planes, thr, coords, tile)

    return jax.jit(shard_map(local, mesh=mesh,
                             in_specs=(P(), P(), P(DATA_AXIS, None)),
                             out_specs=P(DATA_AXIS)))


@functools.lru_cache(maxsize=None)
def _mask_fn(mesh, tile: int):
    def local(planes_i, thr_i, planes_j, thr_j, coords):
        return pw.sweep_mask_bits_ij.__wrapped__(planes_i, thr_i,
                                                 planes_j, thr_j, coords,
                                                 tile)

    return jax.jit(shard_map(local, mesh=mesh,
                             in_specs=(P(), P(), P(), P(),
                                       P(DATA_AXIS, None)),
                             out_specs=P(DATA_AXIS)))


@functools.lru_cache(maxsize=None)
def _compact_fn(mesh, tile: int, cap: int, out_cap: int):
    def local(planes, thr, coords):
        idx, counts = pw.sweep_candidates.__wrapped__(
            planes, thr, coords, tile, cap)
        return pw.compact_indices.__wrapped__(idx, tile, out_cap), counts

    return jax.jit(shard_map(local, mesh=mesh,
                             in_specs=(P(), P(), P(DATA_AXIS, None)),
                             out_specs=(P(DATA_AXIS), P(DATA_AXIS))))


@functools.lru_cache(maxsize=None)
def _compact_words_fn(mesh, tile: int, cap_words: int, out_cap: int):
    def local(planes, thr, coords):
        widx, wvals, cand_counts, word_counts = pw.sweep_words.__wrapped__(
            planes, thr, coords, tile, cap_words)
        packed, vals = pw.compact_words.__wrapped__(widx, wvals, tile,
                                                    out_cap)
        return packed, vals, cand_counts, word_counts

    return jax.jit(shard_map(local, mesh=mesh,
                             in_specs=(P(), P(), P(DATA_AXIS, None)),
                             out_specs=(P(DATA_AXIS), P(DATA_AXIS),
                                        P(DATA_AXIS), P(DATA_AXIS))))


@functools.lru_cache(maxsize=None)
def _extract_fused_heavy_fn(mesh, tile: int, L: int, cap_c: int,
                            gate: bool = False):
    def local(planes_i, thr_i, planes_j, thr_j, coords, bases):
        return pw.sweep_extract_fused_ij.__wrapped__(
            planes_i, thr_i, planes_j, thr_j, coords, bases, tile, L,
            cap_c, gate=gate)

    return jax.jit(shard_map(local, mesh=mesh,
                             in_specs=(P(), P(), P(), P(),
                                       P(DATA_AXIS, None),
                                       P(DATA_AXIS, None)),
                             out_specs=(P(DATA_AXIS), P(DATA_AXIS),
                                        P(DATA_AXIS))))


@functools.lru_cache(maxsize=None)
def _compact_combined_fn(mesh, tile: int, out_cap: int):
    def local(cand_counts, cand_idx, partials, bases):
        return pw.compact_cands_combined.__wrapped__(
            cand_counts, cand_idx, partials, bases, tile, out_cap)

    return jax.jit(shard_map(local, mesh=mesh,
                             in_specs=(P(DATA_AXIS), P(DATA_AXIS),
                                       P(DATA_AXIS), P(DATA_AXIS)),
                             out_specs=P(DATA_AXIS)))


class MeshSweepOps:
    """Mesh-parallel drop-in for the engine's device calls.

    Tile-coordinate batches are padded to a device-count multiple; padding
    rows are (0, 0[, valid=0]) so extraction padding contributes nothing
    (the counts sweep recomputes tile (0,0) — discarded on trim).
    """

    def __init__(self, mesh):
        self.mesh = mesh
        self.n_devices = int(mesh.devices.size)

    # -- staging ------------------------------------------------------------
    def replicate(self, *arrays):
        """Broadcast arrays to every mesh device (the one-time interconnect
        cost)."""
        rep = NamedSharding(self.mesh, P())
        out = tuple(jax.device_put(a, rep) for a in arrays)
        return out if len(out) > 1 else out[0]

    # -- helpers ------------------------------------------------------------
    def _pad(self, coords: np.ndarray):
        coords = np.asarray(coords, dtype=np.int32)
        t = coords.shape[0]
        n = self.n_devices
        tp = ((t + n - 1) // n) * n
        if tp != t:
            pad = np.zeros((tp - t,) + coords.shape[1:], coords.dtype)
            coords = np.concatenate([coords, pad])
        return coords, t

    # -- the three engine device calls ---------------------------------------
    def sweep_counts(self, planes, thr, coords, tile: int) -> np.ndarray:
        cp, t = self._pad(coords)
        out = _counts_fn(self.mesh, tile)(planes, thr, jnp.asarray(cp))
        return np.asarray(out)[:t]

    def sweep_mask_bits(self, planes, thr, bcoords, tile: int,
                        planes_j=None, thr_j=None) -> np.ndarray:
        cp, k = self._pad(bcoords)
        if planes_j is None:
            planes_j, thr_j = planes, thr
        out = _mask_fn(self.mesh, tile)(planes, thr, planes_j, thr_j,
                                        jnp.asarray(cp))
        return np.asarray(out)[:k]

    def sweep_compact(self, planes, thr, bcoords, tile: int, cap: int,
                      out_cap: int):
        """Single-device-layout result: (packed int64 with GLOBAL
        t*tile^2+local encoding and -1 padding, counts (K,) int32). out_cap
        bounds each DEVICE's compacted output (a device's share is <= the
        global total the caller sized out_cap from)."""
        cp, k = self._pad(bcoords)
        k_loc = cp.shape[0] // self.n_devices
        packed, counts = _compact_fn(self.mesh, tile, cap, out_cap)(
            planes, thr, jnp.asarray(cp))
        packed = np.asarray(packed).astype(np.int64) \
            .reshape(self.n_devices, out_cap)
        # device d compacted its local tiles 0..k_loc-1 = global d*k_loc..
        offs = (np.arange(self.n_devices, dtype=np.int64)
                * (k_loc * tile * tile))[:, None]
        packed = np.where(packed >= 0, packed + offs, -1).reshape(-1)
        return packed, np.asarray(counts)[:k]

    def sweep_compact_words(self, planes, thr, bcoords, tile: int,
                            cap_words: int, out_cap: int):
        """Word-granularity variant of sweep_compact (the hot sparse path):
        single-device layout result (packed int64 with GLOBAL
        t*(tile^2/32)+word encoding, word values uint32, candidate counts,
        nonzero-word counts)."""
        cp, k = self._pad(bcoords)
        k_loc = cp.shape[0] // self.n_devices
        wpt = tile * tile // 32
        packed, vals, cand_counts, word_counts = _compact_words_fn(
            self.mesh, tile, cap_words, out_cap)(planes, thr,
                                                 jnp.asarray(cp))
        packed = np.asarray(packed).astype(np.int64) \
            .reshape(self.n_devices, out_cap)
        offs = (np.arange(self.n_devices, dtype=np.int64)
                * (k_loc * wpt))[:, None]
        packed = np.where(packed >= 0, packed + offs, -1).reshape(-1)
        return (packed, np.asarray(vals).reshape(-1),
                np.asarray(cand_counts)[:k], np.asarray(word_counts)[:k])

    def sweep_extract_fused(self, planes, thr, bcoords, bases, tile: int,
                            L: int, cap_c: int,
                            planes_j=None, thr_j=None,
                            gate: bool = False):
        """Mesh version of the round-3 FUSED single-pass heavy program:
        tile coordinates + global bases sharded; returns DEVICE-RESIDENT
        (cand_idx, partials) (for compact_cands_combined) plus counts
        and the padded tile count (counts still device-resident — the
        caller reads them when it needs them). planes_j/thr_j give the
        rectangular (streaming) form; default is symmetric all-vs-all."""
        cp, k = self._pad(bcoords)
        bp = np.zeros((cp.shape[0], 2), dtype=np.int32)
        bp[:len(bases)] = bases[:cp.shape[0]]
        if planes_j is None:
            planes_j, thr_j = planes, thr
        cand_idx, partials, cand_counts = \
            _extract_fused_heavy_fn(self.mesh, tile, L, cap_c, gate)(
                planes, thr, planes_j, thr_j, jnp.asarray(cp),
                jnp.asarray(bp))
        # cp.shape[0] is the PADDED tile count (a multiple of n_devices) —
        # the shape every resident buffer and the downstream
        # compact_cands_combined/split_combined k_pad must agree on. `k`
        # (the unpadded input length) must NOT be returned here: a caller
        # whose batch is not a device-count multiple would misparse the
        # combined buffer.
        return cand_idx, partials, cand_counts, cp.shape[0]

    def compact_cands_combined(self, cand_counts, cand_idx, partials,
                               bases, tile: int, out_cap: int,
                               k_pad: int):
        """Light combined compaction of resident fused buffers: each
        device emits its own single int32 buffer (counts + global
        coordinates + partials); the stacked result still crosses D2H as
        ONE transfer. out_cap bounds each DEVICE's compacted output."""
        bases_pad = np.zeros((k_pad, 2), dtype=np.int32)
        bases_pad[:len(bases)] = bases[:k_pad]
        return _compact_combined_fn(self.mesh, tile, out_cap)(
            cand_counts, cand_idx, partials, jnp.asarray(bases_pad))

    def split_combined(self, buf: np.ndarray, k_pad: int, out_cap: int,
                       PL: int):
        """Host split of the device-stacked combined buffers back into
        the single-device layout (counts in global tile order, candidate
        arrays concatenated)."""
        n = self.n_devices
        k_loc = k_pad // n
        seg = buf.reshape(n, -1)
        parts = [pw.split_combined(seg[dev], k_loc, out_cap, PL)
                 for dev in range(n)]
        return (np.concatenate([p[0] for p in parts]),
                np.concatenate([p[1] for p in parts]),
                np.concatenate([p[2] for p in parts]),
                np.concatenate([p[3] for p in parts]))

    def block_total_max(self, per_tile_counts) -> int:
        """Max over devices of the summed counts in that device's
        contiguous (padded) tile block — the right PER-DEVICE out_cap
        basis. Sizing from the global total would transfer n_devices x the
        data (each device's compaction buffer is out_cap wide)."""
        c = np.asarray(per_tile_counts, dtype=np.int64)
        n = self.n_devices
        k_pad = ((len(c) + n - 1) // n) * n
        padded = np.zeros(k_pad, dtype=np.int64)
        padded[:len(c)] = c
        return int(padded.reshape(n, -1).sum(axis=1).max())

    def max_tiles_scale(self) -> int:
        """Extraction batches may be n_devices times larger: the packed-index
        int32 bound and the HBM buffer bound are both per device."""
        return self.n_devices
