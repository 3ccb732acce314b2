"""One engine run in THIS process, cold-start split on stdout (JSON).

Child half of the cross-process compile-cache demonstration: the
reference's deployment model is one process per shard
(pairwise_comp_optimized.cpp:938-941 job arrays), so what matters is
whether the persistent compile cache (utils/compilecache.py;
``JAX_COMPILATION_CACHE_DIR`` when set) makes the SECOND process's first
dispatch cheap. bench.py's bench_compile_cache() runs this probe twice with
the same program shape against one empty cache directory and records both
``dispatch_first_ms`` values — process 1 compiles, process 2 should hit.

Usage: python tools/compile_cache_probe.py <N> <d> <tile>
"""

import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    N, d, tile = (int(a) for a in sys.argv[1:4])
    from metagenome_vector_sketches_tpu.io.dbfolder import DbFolder
    from metagenome_vector_sketches_tpu.matrix import compute as mc
    rng = np.random.default_rng(9)
    V = rng.integers(-1200, 1201, size=(N, d)).astype(np.int32)
    tmp = tempfile.mkdtemp(prefix="mvs_ccprobe_")
    try:
        db = DbFolder.write(os.path.join(tmp, "db"),
                            [f"S{i}" for i in range(N)], V, d)
        t0 = time.perf_counter()
        mc.compute_pairwise_shard(db.path, os.path.join(tmp, "m"),
                                  tile_rows=tile, verbose=False)
        wall = time.perf_counter() - t0
        st = mc.LAST_STAGES
        walls = st.get("dispatch_walls_ms") or []
        import jax
        print(json.dumps({
            "backend": jax.default_backend(),
            "wall_s": round(wall, 2),
            "dispatch_first_ms": round(walls[0], 1) if walls else None,
            "dispatch_rest_median_ms": (
                round(float(np.median(walls[1:])), 1)
                if len(walls) > 1 else None),
            "cache_dir": jax.config.jax_compilation_cache_dir,
        }))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
