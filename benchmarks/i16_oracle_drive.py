"""On-device oracle drive for an int16-range db (P=6 plane stack).

Verifies the 6-plane schedule end to end on the GPU: synthetic int16-range
vectors -> compute_pairwise_shard -> decoded triples == exact float64
oracle (the gate of chip_smoke.py's pairwise phase, with max_abs pushed
past the L=2 limb range so the engine runs 6 planes).

Run: python benchmarks/i16_oracle_drive.py [n] [d] [tile]
"""

import json
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 3072
    d = int(sys.argv[2]) if len(sys.argv) > 2 else 2048
    tile = int(sys.argv[3]) if len(sys.argv) > 3 else 1024
    from metagenome_vector_sketches_tpu.io.dbfolder import DbFolder
    from metagenome_vector_sketches_tpu.matrix.compute import (
        compute_pairwise_shard, compute_pairwise_oracle)
    from metagenome_vector_sketches_tpu.matrix.reader import MatrixReader
    from metagenome_vector_sketches_tpu.matrix.writer import quantize_jaccard
    from metagenome_vector_sketches_tpu.ops import pairwise as pw
    import jax

    rng = np.random.default_rng(11)
    V = rng.integers(-30000, 30001, size=(n, d)).astype(np.int32)
    V[1] = V[0]
    V[100:130] = V[99] + rng.integers(-60, 61, size=(30, d))
    assert pw.pick_limbs(int(np.abs(V).max())) == 3  # 6 planes
    tmp = tempfile.mkdtemp(prefix="mvs_i16drive_")
    out = {"n": n, "d": d, "tile": tile, "backend": jax.default_backend(),
           "planes": 6}
    try:
        db = DbFolder.write(os.path.join(tmp, "db"),
                            [f"S{i}" for i in range(n)], V, d,
                            use_int16=True)
        stored = db.load_vectors().astype(np.int32)
        t0 = time.perf_counter()
        compute_pairwise_shard(db.path, os.path.join(tmp, "m"),
                               tile_rows=tile, verbose=False)
        out["wall_s"] = round(time.perf_counter() - t0, 2)
        _, norms = db.names_and_norms()
        ns = norms * norms
        er, ec, ev = compute_pairwise_oracle(stored, ns, d, "int16")
        eq = quantize_jaccard(ev, er, ec, ns, d)
        rr, cc, qq = MatrixReader(os.path.join(tmp, "m")) \
            .decode_all_triples(n)
        out["triples"] = len(rr)
        out["oracle_equal"] = set(zip(rr.tolist(), cc.tolist(),
                                      qq.tolist())) == \
            set(zip(er.tolist(), ec.tolist(), eq.tolist()))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps(out))
    assert out["oracle_equal"], "int16 P=6 engine diverged from oracle"


if __name__ == "__main__":
    main()
