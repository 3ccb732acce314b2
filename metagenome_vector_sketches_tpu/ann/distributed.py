"""Distributed ANN indexes over a device mesh.

DistributedFlatIPIndex: database rows sharded, queries replicated,
per-device fused dot+top-k merged with an all-gather + re-top-k
(parallel.pairwise.distributed_topk). Drop-in for FlatIPIndex.search at
pod scale.

DistributedIntExactIndex: the int8-plane exact engine's chunk stack
sharded on the chunk axis; each device scans its local chunks with
globalized indices, then the per-device candidate pools (scores, indices
AND exact plane partials) merge with one all-gather + re-top-k —
the host finalize (exact int64 dots, float64 cosine ranking) is unchanged
from the single-chip engine."""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from jax import shard_map

from ..ops import pairwise as pw
from ..parallel.mesh import make_mesh, row_sharding, replicated, DATA_AXIS
from ..parallel.pairwise import distributed_topk
from .flat_index import FlatIPIndex
from .int_index import (IntExactIndex, _int_scan_pool, _host_planes,
                        _inv_norms)


def _replicate_on(mesh, x):
    """Replicate a host value over the mesh; on a multi-process mesh the
    (identical-on-every-process) value must enter through
    make_array_from_process_local_data."""
    if any(d.process_index != jax.process_index()
           for d in mesh.devices.flat):
        return jax.make_array_from_process_local_data(
            replicated(mesh), np.asarray(x), global_shape=tuple(x.shape))
    return jax.device_put(x, replicated(mesh))


class DistributedFlatIPIndex:
    def __init__(self, vectors: np.ndarray, mesh=None,
                 recall_target: float = 1.0):
        """vectors: (n, d) float32 L2-normalized. Rows are padded to a
        multiple of the mesh size (pad rows are zero => never in top-k unless
        k exceeds the true matches, mirroring FAISS's -1 semantics is handled
        by score masking). recall_target < 1.0 uses approx_max_k for the
        per-device local selection (the cross-device merge stays exact)."""
        self.mesh = mesh if mesh is not None else make_mesh()
        n_dev = self.mesh.devices.size
        n, d = vectors.shape
        self.ntotal = n
        self.recall_target = float(recall_target)
        self._row_ids = None
        npad = ((n + n_dev - 1) // n_dev) * n_dev
        padded = np.zeros((npad, d), dtype=np.float32)
        padded[:n] = vectors
        self.v = jax.device_put(jnp.asarray(padded), row_sharding(self.mesh))

    @classmethod
    def from_flat(cls, index: FlatIPIndex, mesh=None):
        return cls(index.vectors, mesh=mesh,
                   recall_target=index.recall_target)

    @classmethod
    def from_process_shards(cls, vectors_local: np.ndarray, d: int,
                            mesh=None, recall_target: float = 1.0
                            ) -> "DistributedFlatIPIndex":
        """COLLECTIVE constructor for multi-process runs (call on every
        process): each process contributes only its own L2-normalized
        float32 row block; global row ids are assigned in
        jax.process_index() order and no host ever holds the whole
        database. Per-process pad rows are interleaved in the global
        layout, so searches ride explicit per-row ids
        (parallel.pairwise.distributed_topk row_ids) instead of the
        contiguous n_valid mask. Degenerates to the single-process build
        on a 1-process mesh."""
        from jax.experimental import multihost_utils
        mesh = mesh if mesh is not None else make_mesh()
        V = np.ascontiguousarray(vectors_local, dtype=np.float32)
        n_local = int(V.shape[0])
        counts = np.asarray(multihost_utils.process_allgather(
            np.array([n_local], np.int64))).reshape(-1)
        n_total = int(counts.sum())
        pid = jax.process_index()
        base_p = int(counts[:pid].sum())
        n_proc = len(counts)
        n_dev = mesh.devices.size
        ldc = n_dev // n_proc
        assert ldc * n_proc == n_dev, \
            "mesh devices must split evenly across processes"
        rows_pp = ((max(int(counts.max()), 1) + ldc - 1) // ldc) * ldc
        padded = np.zeros((rows_pp, d), dtype=np.float32)
        padded[:n_local] = V
        ids = np.full(rows_pp, -1, dtype=np.int32)
        ids[:n_local] = base_p + np.arange(n_local, dtype=np.int32)
        self = cls.__new__(cls)
        self.mesh = mesh
        self.ntotal = n_total
        self.recall_target = float(recall_target)
        self.v = jax.make_array_from_process_local_data(
            row_sharding(mesh), padded,
            global_shape=(rows_pp * n_proc, int(d)))
        self._row_ids = jax.make_array_from_process_local_data(
            NamedSharding(mesh, P(DATA_AXIS)), ids,
            global_shape=(rows_pp * n_proc,))
        return self

    def search_device(self, queries_dev, k: int):
        """Device-in/device-out search at k_eff = min(k, ntotal) — the
        adaptive expanding loop's contract (FlatIPIndex.search_device)."""
        k_eff = min(k, max(1, self.ntotal))
        q = _replicate_on(self.mesh, queries_dev)
        return distributed_topk(self.mesh, q, self.v, k_eff,
                                n_valid=self.ntotal,
                                recall_target=self.recall_target,
                                row_ids=self._row_ids)

    def search(self, queries: np.ndarray, k: int):
        q = _replicate_on(
            self.mesh,
            jnp.asarray(np.ascontiguousarray(queries, dtype=np.float32)))
        # n_valid / row_ids mask the pad rows to -inf inside the kernel so
        # they cannot displace genuine negative-inner-product neighbors
        D, I = distributed_topk(self.mesh, q, self.v, k,
                                n_valid=self.ntotal,
                                recall_target=self.recall_target,
                                row_ids=self._row_ids)
        D, I = np.array(D), np.array(I)
        bad = ~np.isfinite(D) | (I >= self.ntotal)
        D[bad] = 0.0
        I[bad] = -1
        return D, I


@functools.lru_cache(maxsize=None)
def _int_pool_fn(mesh, pool: int, rt: float, selector: str = "topk"):
    """Mesh-sharded candidate pooling for the int8-plane engine: local
    scan over this device's chunk shard (global indices from the sharded
    per-chunk base-id/valid-count arrays, so arbitrary — e.g. per-process
    — row layouts work), then ONE all-gather of the (score, index,
    partials) pools + re-top-k. Per-query interconnect traffic is
    pool * (8 + 4P) bytes — independent of N."""

    def step(qp, stack_local, inv_local, bases_local, valid_local):
        s, i, p = _int_scan_pool.__wrapped__(
            qp, stack_local, inv_local, 0, pool,
            recall_target=rt, selector=selector,
            bases=bases_local, valid=valid_local)
        s_all = jax.lax.all_gather(s, DATA_AXIS, axis=1, tiled=True)
        i_all = jax.lax.all_gather(i, DATA_AXIS, axis=1, tiled=True)
        p_all = jax.lax.all_gather(p, DATA_AXIS, axis=2, tiled=True)
        # the merged pool may exceed a device's local C_l*R cap — re-top-k
        # at the full requested pool so tiny shards still fill it
        ns, sel = jax.lax.top_k(s_all, min(pool, s_all.shape[1]))
        ni = jnp.take_along_axis(i_all, sel, axis=1)
        nP = jnp.take_along_axis(p_all, sel[None], axis=2)
        return ns, ni, nP

    fn = shard_map(step, mesh=mesh,
                   in_specs=(P(), P(DATA_AXIS, None, None, None),
                             P(DATA_AXIS, None), P(DATA_AXIS), P(DATA_AXIS)),
                   out_specs=(P(), P(), P()),
                   check_vma=False)  # identical on all devices post-gather
    return jax.jit(fn)


class DistributedIntExactIndex(IntExactIndex):
    """IntExactIndex with its chunk stack sharded over a mesh: same search
    contract (float64-exact cosines), candidate pooling fanned out over
    the devices. Build the base index first (any construction path), then
    wrap: ``DistributedIntExactIndex.from_index(idx, mesh)`` — or, on a
    multi-process run, build it collectively from per-process row blocks
    with ``from_process_shards`` (no process ever holds the whole db)."""

    def __init__(self, *a, **kw):
        raise TypeError("use DistributedIntExactIndex.from_index(...) or "
                        ".from_process_shards(...)")

    @classmethod
    def from_index(cls, index: IntExactIndex,
                   mesh=None) -> "DistributedIntExactIndex":
        mesh = mesh if mesh is not None else make_mesh()
        n_dev = mesh.devices.size
        C, Pn, R, d = index._stack.shape
        Cpad = ((C + n_dev - 1) // n_dev) * n_dev
        stack, inv = index._stack, index._inv_n
        if Cpad != C:
            # pad chunks carry valid=0 => fully masked inside the scan
            stack = jnp.concatenate(
                [stack, jnp.zeros((Cpad - C, Pn, R, d), jnp.int8)])
            inv = jnp.concatenate(
                [inv, jnp.zeros((Cpad - C, R), jnp.float32)])
        n = index._shape[0]
        bases = np.arange(Cpad, dtype=np.int32) * R
        valid = np.clip(n - bases.astype(np.int64), 0, R).astype(np.int32)
        self = cls.__new__(cls)
        self._shape = index._shape
        self.chunk_rows = index.chunk_rows
        self.mode = index.mode
        self.recall_target = index.recall_target
        self.pool_margin = index.pool_margin
        self.selector = index.selector
        self.max_abs = index.max_abs
        self.L = index.L
        self.ns = index.ns
        self.mesh = mesh
        self._stack = jax.device_put(
            stack, NamedSharding(mesh, P(DATA_AXIS, None, None, None)))
        self._inv_n = jax.device_put(
            inv, NamedSharding(mesh, P(DATA_AXIS, None)))
        self._bases = jax.device_put(
            jnp.asarray(bases), NamedSharding(mesh, P(DATA_AXIS)))
        self._valid = jax.device_put(
            jnp.asarray(valid), NamedSharding(mesh, P(DATA_AXIS)))
        return self

    @classmethod
    def from_dbfolder(cls, db_folder: str, mesh=None,
                      chunk_rows: int = 65536, mode: str = "exact",
                      recall_target: float = 0.95
                      ) -> "DistributedIntExactIndex":
        """Stage a db folder DIRECTLY into the sharded chunk-stack layout:
        each chunk's int8 planes go straight to the device that owns it
        (per-device peak = its stack shard + one chunk). Building a
        single-device IntExactIndex first and wrapping it with from_index
        transiently holds the whole stack on one chip PLUS the padded
        sharded copy — at N=1M x d=2048 that is ~2x a 6 GB stack on device
        0, which OOMs exactly the regime sharding serves. Single-process
        meshes only (multi-process runs use from_process_shards)."""
        from ..ops.pairwise import num_planes
        from .int_index import _dbfolder_staging, _stack_update
        assert mode in ("exact", "approx"), mode
        mesh = mesh if mesh is not None else make_mesh()
        devs = list(mesh.devices.flat)
        if any(dd.process_index != jax.process_index() for dd in devs):
            raise ValueError(
                "from_dbfolder stages from one process; on multi-process "
                "meshes build collectively with from_process_shards")
        n, d, max_abs, L, R, C, ns, chunks = _dbfolder_staging(
            db_folder, chunk_rows)
        Pn = num_planes(L)
        n_dev = len(devs)
        Cpad = ((C + n_dev - 1) // n_dev) * n_dev
        Cl = Cpad // n_dev
        # per-device zero buffers created ON their device (no H2D/D2D of
        # gigabytes of zeros)
        shard_sh = jax.sharding.SingleDeviceSharding
        bufs = [jax.jit(lambda: jnp.zeros((Cl, Pn, R, d), jnp.int8),
                        out_shardings=shard_sh(dd))() for dd in devs]
        for c, limbs in chunks:
            dev = devs[c // Cl]
            # device_put STRAIGHT from the numpy array: jnp.asarray first
            # would materialize the chunk on the default device and then
            # copy D2D, doubling staging traffic and funneling every
            # chunk through device 0's HBM
            lb = jax.device_put(limbs, dev)
            bufs[c // Cl] = _stack_update(bufs[c // Cl], lb,
                                          jnp.int32(c % Cl))
        sharding = NamedSharding(mesh, P(DATA_AXIS, None, None, None))
        stack = jax.make_array_from_single_device_arrays(
            (Cpad, Pn, R, d), sharding, bufs)
        bases = np.arange(Cpad, dtype=np.int32) * R
        valid = np.clip(n - bases.astype(np.int64), 0, R).astype(np.int32)
        self = cls.__new__(cls)
        self._shape = (n, d)
        self.chunk_rows = R
        self.mode = mode
        self.recall_target = float(recall_target)
        self.pool_margin = 64
        self.selector = "topk"
        self.max_abs = max_abs
        self.L = L
        self.ns = ns
        self.mesh = mesh
        self._stack = stack
        self._inv_n = jax.device_put(
            jnp.asarray(_inv_norms(ns, Cpad, R, n)),
            NamedSharding(mesh, P(DATA_AXIS, None)))
        self._bases = jax.device_put(
            jnp.asarray(bases), NamedSharding(mesh, P(DATA_AXIS)))
        self._valid = jax.device_put(
            jnp.asarray(valid), NamedSharding(mesh, P(DATA_AXIS)))
        return self

    @classmethod
    def from_process_shards(cls, vectors_local: np.ndarray, d: int,
                            mesh=None, chunk_rows: int = 65536,
                            mode: str = "exact",
                            recall_target: float = 0.95
                            ) -> "DistributedIntExactIndex":
        """COLLECTIVE constructor for multi-process runs (call on every
        process): each process contributes only its own row block
        (``vectors_local``, (n_local, d) integer; global row ids are
        assigned in jax.process_index() order), so no host ever
        materializes the whole database. Metadata (row counts, max
        component, exact |v|^2 norms — the small host-finalize inputs)
        is exchanged with process_allgather; the int8 plane chunks stay
        process-local and become the global sharded stack via
        jax.make_array_from_process_local_data. Degenerates to the
        single-process build on a 1-process mesh.

        Mirrors the reference's per-task row blocks (SURVEY §2.3 job-array
        model) but serves ONE logical index over all of them."""
        from jax.experimental import multihost_utils
        assert mode in ("exact", "approx"), mode
        mesh = mesh if mesh is not None else make_mesh()
        V = np.asarray(vectors_local)
        if V.size and V.dtype not in (np.int8, np.int16, np.int32):
            raise ValueError("integer vectors required; got %s" % V.dtype)
        n_local = int(V.shape[0])
        max_abs_local = (int(np.max(np.abs(V.astype(np.int64))))
                         if n_local else 0)
        meta = np.asarray(multihost_utils.process_allgather(
            np.array([n_local, max_abs_local], np.int64)))
        meta = meta.reshape(-1, 2)                 # (n_proc, 2)
        n_locals = meta[:, 0]
        n_total = int(n_locals.sum())
        pid = jax.process_index()
        base_p = int(n_locals[:pid].sum())
        max_abs = int(meta[:, 1].max())
        L = pw.pick_limbs(max(1, max_abs))
        Pn = pw.num_planes(L)
        R = int(min(chunk_rows, max(1, n_total)))  # same on all processes
        n_dev = mesh.devices.size
        n_proc = len(n_locals)
        ldc = n_dev // n_proc
        assert ldc * n_proc == n_dev, \
            "mesh devices must split evenly across processes"
        # equal chunk count per process, divisible by its device count
        c_need = int(max((n_locals + R - 1) // R))
        Cp = ((max(c_need, 1) + ldc - 1) // ldc) * ldc
        stack = np.zeros((Cp, Pn, R, d), dtype=np.int8)
        bases = np.zeros(Cp, dtype=np.int32)
        valid = np.zeros(Cp, dtype=np.int32)
        ns_local = np.zeros(Cp * R, dtype=np.int64)
        for c in range((n_local + R - 1) // R):
            s, e = c * R, min((c + 1) * R, n_local)
            block = np.zeros((R, d), dtype=np.int32)
            block[:e - s] = V[s:e]
            stack[c] = _host_planes(block, L)
            ns_local[s:e] = np.einsum("ij,ij->i",
                                      block[:e - s].astype(np.int64),
                                      block[:e - s].astype(np.int64))
            bases[c] = base_p + s
            valid[c] = e - s
        inv = _inv_norms(ns_local[:n_local], Cp, R, n_local)
        # exact norms for the host finalize: gather the (small) per-process
        # blocks and concatenate in process order = global id order
        ns_all = np.asarray(multihost_utils.process_allgather(ns_local))
        ns_all = ns_all.reshape(n_proc, Cp * R)
        ns = np.concatenate([ns_all[p, :int(n_locals[p])]
                             for p in range(n_proc)])
        self = cls.__new__(cls)
        self._shape = (n_total, int(d))
        self.chunk_rows = R
        self.mode = mode
        self.recall_target = float(recall_target)
        self.pool_margin = 64
        self.selector = "topk"
        self.max_abs = max_abs
        self.L = L
        self.ns = ns
        self.mesh = mesh
        self._stack = jax.make_array_from_process_local_data(
            NamedSharding(mesh, P(DATA_AXIS, None, None, None)), stack,
            global_shape=(Cp * n_proc, Pn, R, d))
        self._inv_n = jax.make_array_from_process_local_data(
            NamedSharding(mesh, P(DATA_AXIS, None)), inv,
            global_shape=(Cp * n_proc, R))
        self._bases = jax.make_array_from_process_local_data(
            NamedSharding(mesh, P(DATA_AXIS)), bases,
            global_shape=(Cp * n_proc,))
        self._valid = jax.make_array_from_process_local_data(
            NamedSharding(mesh, P(DATA_AXIS)), valid,
            global_shape=(Cp * n_proc,))
        return self

    def _pool(self, qp, pool: int, rt: float):
        return _int_pool_fn(self.mesh, pool, rt, self.selector)(
            _replicate_on(self.mesh, qp), self._stack, self._inv_n,
            self._bases, self._valid)
