"""TRUE multi-process distributed test.

Spawns 2 OS processes, each with 2 virtual CPU devices, joined through
jax.distributed.initialize with a local coordinator — so host_shards,
the per-process local-mesh engine, cross-process collectives over the
distributed backend, and the global-mesh distributed top-k are all
exercised for real (round 1 only ever ran jax.distributed in-process).

The parent then merges the per-process shard artifacts through the reader
and checks them against the float64 oracle.
"""

import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
from helpers import assert_matrix_matches_oracle

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_DRIVER = textwrap.dedent("""
    import os, sys
    sys.path.insert(0, {repo!r})
    import jax
    jax.config.update("jax_platforms", "cpu")
    import numpy as np
    pid = int(sys.argv[1]); nproc = int(sys.argv[2]); coord = sys.argv[3]
    db_path = sys.argv[4]; out_path = sys.argv[5]

    from metagenome_vector_sketches_tpu.parallel import multihost
    multihost.initialize(coordinator_address=coord, num_processes=nproc,
                         process_id=pid)
    assert jax.process_count() == nproc, jax.process_count()
    assert len(jax.devices()) == 2 * nproc, len(jax.devices())
    assert len(jax.local_devices()) == 2

    # 1) DCN-level collective smoke: psum over the 4-device global mesh
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    mesh = multihost.global_mesh()
    sh = NamedSharding(mesh, P("data"))
    local = np.full((2,), float(pid + 1), dtype=np.float32)
    garr = jax.make_array_from_process_local_data(sh, local)
    tot = jax.jit(jnp.sum, out_shardings=NamedSharding(mesh, P()))(garr)
    want = sum(2.0 * (k + 1) for k in range(nproc))
    assert float(tot) == want, (float(tot), want)

    # 2) the flagship: this process's strided shards, each mesh-parallel
    #    over the process's local devices
    folders = multihost.compute_pairwise_multihost(
        db_path, out_path, num_shards=4, tile_rows=8, verbose=False)
    assert folders == [os.path.join(out_path, f"shard_{{s}}")
                       for s in range(pid, 4, nproc)], folders

    # 3) distributed top-k over the GLOBAL mesh (rows sharded across
    #    processes, queries replicated)
    from metagenome_vector_sketches_tpu.parallel.pairwise import (
        distributed_topk)
    from metagenome_vector_sketches_tpu.ann.flat_index import normalize_l2
    rng = np.random.default_rng(5)             # same on every process
    N, d, B, k = 64, 32, 3, 5
    V = normalize_l2(rng.normal(size=(N, d)).astype(np.float32))
    Q = normalize_l2(rng.normal(size=(B, d)).astype(np.float32))
    vsh = NamedSharding(mesh, P("data", None))
    V_g = jax.make_array_from_callback(V.shape, vsh, lambda i: V[i])
    Q_g = jax.make_array_from_callback(
        Q.shape, NamedSharding(mesh, P()), lambda i: Q[i])
    D, I = distributed_topk(mesh, Q_g, V_g, k)
    I = np.asarray(I)
    scores = Q.astype(np.float64) @ V.astype(np.float64).T
    for b in range(B):
        assert set(I[b].tolist()) == set(np.argsort(-scores[b])[:k].tolist())

    # 4) int8-plane exact ANN built COLLECTIVELY from per-process row
    #    blocks (uneven split, non-chunk-multiple sizes => pad chunks and
    #    the explicit bases/valid path are exercised for real)
    from metagenome_vector_sketches_tpu.ann.distributed import (
        DistributedIntExactIndex)
    rngi = np.random.default_rng(7)                # same draw everywhere
    Ni, di, ki = 50, 32, 7
    Vi = rngi.integers(-300, 301, size=(Ni, di)).astype(np.int32)
    Qi = rngi.integers(-300, 301, size=(3, di)).astype(np.int32)
    splits = [0, 22, Ni]
    idx = DistributedIntExactIndex.from_process_shards(
        Vi[splits[pid]:splits[pid + 1]], di, mesh=mesh, chunk_rows=8)
    assert idx.ntotal == Ni, idx.ntotal
    D, I = idx.search(Qi, ki)
    num = Qi.astype(np.float64) @ Vi.astype(np.float64).T
    den = (np.sqrt(np.einsum("ij,ij->i", Qi.astype(np.float64),
                             Qi.astype(np.float64)))[:, None]
           * np.sqrt(np.einsum("ij,ij->i", Vi.astype(np.float64),
                               Vi.astype(np.float64)))[None, :])
    sc = num / den
    for b in range(3):
        want = sc[b][np.argsort(-sc[b])[:ki]]
        assert np.allclose(np.sort(D[b]), np.sort(want), atol=1e-6), b
        assert np.allclose(sc[b][I[b]], D[b], atol=1e-12), b

    # 5) f32 flat index built collectively from per-process row blocks
    #    (explicit row-id masking: per-process pad rows sit in the MIDDLE
    #    of the global layout)
    from metagenome_vector_sketches_tpu.ann.distributed import (
        DistributedFlatIPIndex)
    from metagenome_vector_sketches_tpu.ann.flat_index import normalize_l2
    rngf = np.random.default_rng(11)
    Nf, df, kf = 45, 24, 6
    Vf = normalize_l2(rngf.normal(size=(Nf, df)).astype(np.float32))
    Qf = normalize_l2(rngf.normal(size=(2, df)).astype(np.float32))
    fsplits = [0, 19, Nf]
    fidx = DistributedFlatIPIndex.from_process_shards(
        Vf[fsplits[pid]:fsplits[pid + 1]], df, mesh=mesh)
    assert fidx.ntotal == Nf, fidx.ntotal
    Df, If = fidx.search(Qf, kf)
    fsc = Qf.astype(np.float64) @ Vf.astype(np.float64).T
    for b in range(2):
        want = np.sort(fsc[b][np.argsort(-fsc[b])[:kf]])
        assert np.allclose(np.sort(Df[b]), want, atol=1e-6), b
        assert np.all(If[b] >= 0) and np.all(If[b] < Nf)

    jax.distributed.shutdown()
    print(f"DISTOK {{pid}}")
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_distributed_pairwise(tmp_path):
    from metagenome_vector_sketches_tpu.io.dbfolder import DbFolder
    from metagenome_vector_sketches_tpu.matrix.compute import (
        compute_pairwise_shard)
    from metagenome_vector_sketches_tpu.matrix.reader import MatrixReader
    from metagenome_vector_sketches_tpu.matrix.writer import quantize_jaccard

    rng = np.random.default_rng(9)
    n, d = 40, 64
    V = rng.integers(-200, 201, size=(n, d)).astype(np.int32)
    V[1] = V[0] + 1
    V[17] = V[16]
    db = DbFolder.write(str(tmp_path / "db"), [f"S{i}" for i in range(n)],
                        V, d)
    out = str(tmp_path / "m")

    driver = tmp_path / "driver.py"
    driver.write_text(_DRIVER.format(repo=REPO))
    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ,
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2",
               JAX_NUM_CPU_DEVICES="2")
    procs = [subprocess.Popen(
        [sys.executable, str(driver), str(pid), "2", coord, db.path, out],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, text=True)
        for pid in range(2)]
    outs = []
    try:
        for p in procs:
            stdout, _ = p.communicate(timeout=420)
            outs.append(stdout)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.skip("distributed coordinator timed out on this host")
    for pid, (p, stdout) in enumerate(zip(procs, outs)):
        if p.returncode != 0 and ("UNAVAILABLE" in stdout
                                  or "Address already in use" in stdout):
            pytest.skip(f"coordinator port unavailable: {stdout[-200:]}")
        assert p.returncode == 0, f"proc {pid} failed:\n{stdout[-4000:]}"
        assert f"DISTOK {pid}" in stdout

    # the artifacts from BOTH processes merge through the shard reader
    _, norms = db.names_and_norms()
    ns = norms * norms
    assert_matrix_matches_oracle(V, ns, d, out, n)
    assert sorted(os.listdir(out)) == [f"shard_{s}" for s in range(4)]
