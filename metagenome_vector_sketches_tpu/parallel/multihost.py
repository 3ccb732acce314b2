"""Multi-host orchestration.

The reference scales across machines by launching one process per
--shard_idx from an HPC job array, with the filesystem as the only
"collective" (SURVEY.md §2.3). This framework keeps that contract — shard
folders remain independently restartable units — and adds genuine multi-host
execution on top:

- :func:`initialize` wraps jax.distributed.initialize (env-driven, safe to
  call on single host).
- :func:`host_shards` maps the reference's shard space onto hosts
  (process k computes shards k, k+P, k+2P, ... — drop-in for a job array).
- :func:`global_mesh` builds a mesh over all global devices; the sharded
  pairwise sweep / distributed top-k in parallel.pairwise then use
  standard GSPMD collectives within and across hosts.
"""

from __future__ import annotations

import os

import jax

from .mesh import make_mesh


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Initialize jax.distributed from args or environment
    (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID). A no-op
    when neither args nor env request a multi-process run."""
    addr = coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if addr is None and num_processes is None:
        return
    # read the WHOLE documented env triple, not just the address: on
    # hosts without cluster auto-detection, initialize() with only an
    # address raises "Number of processes must be defined"
    if num_processes is None and "JAX_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and "JAX_PROCESS_ID" in os.environ:
        process_id = int(os.environ["JAX_PROCESS_ID"])
    jax.distributed.initialize(coordinator_address=addr,
                               num_processes=num_processes,
                               process_id=process_id)


def process_info() -> tuple[int, int]:
    """(process_index, process_count)."""
    return jax.process_index(), jax.process_count()


def host_shards(num_shards: int) -> list[int]:
    """The shard indices this host is responsible for (strided assignment,
    equivalent to an HPC array job of num_shards tasks over P hosts)."""
    pid, pcount = process_info()
    return list(range(pid, num_shards, pcount))


def global_mesh(axis: str = "data"):
    """1-D mesh over ALL global devices (multi-host aware)."""
    return make_mesh(None, axis=axis)


def compute_pairwise_multihost(db_folder: str, output_folder: str,
                               num_shards: int, use_local_mesh: bool = True,
                               **kwargs) -> list[str]:
    """Run this host's share of the shard space (call on every host).
    Returns the shard folders written by this host.

    With use_local_mesh (default), each shard runs mesh-parallel over THIS
    host's chips (parallel.engine) — so a P-host, C-chip/host run gets
    shard-level scatter over DCN (the reference's job-array model) times
    C-way tile parallelism inside every shard."""
    from ..matrix.compute import compute_pairwise_shard
    from .mesh import local_mesh
    if "mesh" in kwargs:
        mesh = kwargs.pop("mesh")
    else:
        mesh = local_mesh() if use_local_mesh else None
    out = []
    for shard_idx in host_shards(num_shards):
        out.append(compute_pairwise_shard(db_folder, output_folder,
                                          num_shards=num_shards,
                                          shard_idx=shard_idx, mesh=mesh,
                                          **kwargs))
    return out
