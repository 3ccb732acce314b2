#!/usr/bin/env python3
"""Run the reference's pipeline once on NVIDIA GPUs, at its production N.

    python chip_smoke.py           # one GPU: phases a-f below
    python chip_smoke.py --four    # four GPUs: mesh of 4 against 1 only

Every step goes through the CLIs a user runs (each CLI's ``main(argv)``,
in this one process, so one process holds the card and every step shares
one compile cache):

  a. card and runtime; the tests marked ``chip`` (pytest, in-process)
  b. ``project_everything sketch`` of the reference toy hashes, byte-equal
     to the reference's db folders; 256 FracMinHash sets with log-uniform
     sizes 1e3..1e6 projected on the device, 8 of them checked bit-equal
     against the host projection
  c. ``project_everything sketch`` + ``pairwise_comp`` shard 0 of 16 at
     N = 697,508 (reference README.md:111), d = 2048, int32; sampled rows
     checked against the exact int64 oracle, planted recall 1.0
  d. ``query_pc_mat`` top-10 for 1,000 planted rows of shard 0
  e. ``jaccard index`` + ``jaccard search -j 0.1`` (f32 and int8 engines),
     64 queries compared with float64 brute force over all N
  f. the result: one JSON object on the last line of stdout

Data is generated from ``--seed``. It exits non-zero, printing no result,
when JAX finds no GPU or any phase fails.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import subprocess
import sys
import time
import traceback
from concurrent.futures import ThreadPoolExecutor

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, ".chip_smoke")

N = 697_508                   # reference README.md:111
D = 2048
NUM_SHARDS = 16
J_SEARCH = 0.1

# Data model of the pairwise phase: groups of GROUP accessions share
# SHARED of their BASE hashes (pair Jaccard 160/352 = 0.45, far above the
# retention threshold); the last N/128 accessions carry HEAVY hashes so the
# largest component passes 127 and the engine runs two limbs (3 planes).
GROUP, BASE, SHARED, HEAVY = 4, 256, 160, 2048
CHUNK_ROWS = 4096             # generator work unit; a multiple of GROUP
# FracMinHash with scaled=1000 keeps hashes below 2^64/1000. The pairwise
# data draws from [1e16, 2^64/1000) so every hash prints as 17 digits and
# every line of all_hashes.txt has a length known in advance.
MAX_HASH = (1 << 64) // 1000
LO_HASH = 10 ** 16
HASH_W = 17
PREFIX_W = len("ACC0000000: ")


# ---------------------------------------------------------------------------
# Phase bookkeeping
# ---------------------------------------------------------------------------

class Phases:
    """Wall time and JAX compile time (trace + lower + backend compile, as
    JAX's own monitoring events report them) of each phase."""

    def __init__(self):
        self.results: dict = {}
        self._compile = 0.0

    def on_duration(self, event: str, secs: float, **_):
        if event.startswith("/jax/core/compile/"):
            self._compile += secs

    @contextlib.contextmanager
    def run(self, name: str):
        t0 = time.perf_counter()
        c0 = self._compile
        rec = {"ok": False}
        self.results[name] = rec
        print(f"[{name}] start", flush=True)
        try:
            yield rec
        except Exception:
            traceback.print_exc()
            rec["error"] = traceback.format_exc(limit=1).strip()[-400:]
            raise
        finally:
            wall = time.perf_counter() - t0
            comp = self._compile - c0
            rec.update(wall_s=wall, compile_s=comp, warm_s=wall - comp)
            print(f"[{name}] " + json.dumps(rec, default=_jsonable),
                  flush=True)


def _jsonable(x):
    if isinstance(x, np.generic):
        return x.item()
    if isinstance(x, np.ndarray):
        return x.tolist()
    return str(x)


def cli(main, argv, log_path: str) -> None:
    """One CLI call, in-process, its stdout appended to log_path."""
    t0 = time.perf_counter()
    with open(log_path, "a") as f, contextlib.redirect_stdout(f):
        print("$ " + " ".join(map(str, argv)), flush=True)
        try:
            rc = main([str(a) for a in argv])
        except SystemExit as e:
            rc = e.code
    print(f"  {main.__module__.rsplit('.', 1)[-1]} {argv[0]}: exit {rc}, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if rc not in (0, None):
        raise RuntimeError(f"{argv[:2]} exited {rc}; see {log_path}")


# ---------------------------------------------------------------------------
# all_hashes.txt generator (numpy only; threads, no second JAX process)
# ---------------------------------------------------------------------------

class PlantedData:
    def __init__(self, N: int, seed: int):
        self.N = N
        self.seed = seed
        self.n_groups = max(1, N // 64)
        self.n_heavy = max(1, N // 128)
        self.grouped_end = self.n_groups * GROUP
        self.heavy_start = N - self.n_heavy
        assert self.grouped_end <= self.heavy_start

    def offset(self, row: int) -> int:
        """Byte offset of row's line (every line's length is fixed)."""
        light = min(row, self.heavy_start)
        heavy = max(0, row - self.heavy_start)
        return PREFIX_W * row + (HASH_W + 1) * (BASE * light + HEAVY * heavy)

    def chunk(self, c: int):
        """[(first_row, (rows, width) uint64 hashes)] for chunk c."""
        s, e = c * CHUNK_ROWS, min((c + 1) * CHUNK_ROWS, self.N)
        rng = np.random.default_rng([self.seed, c])
        parts = []
        gs, ge = s, min(e, self.grouped_end)
        if ge > gs:
            ng = (ge - gs) // GROUP
            shared = rng.integers(LO_HASH, MAX_HASH, (ng, 1, SHARED),
                                  dtype=np.uint64)
            own = rng.integers(LO_HASH, MAX_HASH, (ng, GROUP, BASE - SHARED),
                               dtype=np.uint64)
            m = np.concatenate(
                [np.broadcast_to(shared, (ng, GROUP, SHARED)), own], axis=2)
            parts.append((gs, m.reshape(ng * GROUP, BASE)))
        ls, le = max(s, self.grouped_end), min(e, self.heavy_start)
        if le > ls:
            parts.append((ls, rng.integers(LO_HASH, MAX_HASH, (le - ls, BASE),
                                           dtype=np.uint64)))
        hs = max(s, self.heavy_start)
        if e > hs:
            parts.append((hs, rng.integers(LO_HASH, MAX_HASH, (e - hs, HEAVY),
                                           dtype=np.uint64)))
        return parts

    def row_hashes(self, rows) -> list[np.ndarray]:
        cache: dict = {}
        out = []
        for r in rows:
            c = int(r) // CHUNK_ROWS
            if c not in cache:
                cache[c] = self.chunk(c)
            for first, m in cache[c]:
                if first <= r < first + len(m):
                    out.append(np.array(m[r - first]))
        return out

    def mates(self, row: int) -> set[int]:
        g = row // GROUP
        return {g * GROUP + k for k in range(GROUP)} - {row}

    def write(self, path: str, workers: int) -> int:
        total = self.offset(self.N)
        n_chunks = (self.N + CHUNK_ROWS - 1) // CHUNK_ROWS
        fd = os.open(path, os.O_CREAT | os.O_TRUNC | os.O_WRONLY, 0o644)
        try:
            os.ftruncate(fd, total)

            def one(c):
                for first, m in self.chunk(c):
                    buf = format_lines(first, m)
                    view, off = memoryview(buf).cast("B"), self.offset(first)
                    while len(view):
                        n = os.pwrite(fd, view, off)
                        view, off = view[n:], off + n

            with ThreadPoolExecutor(max_workers=workers) as pool:
                for _ in pool.map(one, range(n_chunks)):
                    pass
        finally:
            os.close(fd)
        return total


def format_lines(first_row: int, m: np.ndarray) -> np.ndarray:
    """'ACC%07d: h1 h2 ...\\n' lines as one uint8 array (17-digit hashes)."""
    rows, w = m.shape
    line = np.empty((rows, PREFIX_W + (HASH_W + 1) * w), dtype=np.uint8)
    line[:, :3] = np.frombuffer(b"ACC", dtype=np.uint8)
    idx = np.arange(first_row, first_row + rows, dtype=np.int64)
    for k in range(9, 2, -1):
        line[:, k] = (idx % 10 + 48).astype(np.uint8)
        idx //= 10
    line[:, 10] = ord(":")
    line[:, 11] = ord(" ")
    digits = line[:, PREFIX_W:].reshape(rows, w, HASH_W + 1)
    digits[:, :, HASH_W] = ord(" ")
    x = m.copy()
    ten = np.uint64(10)
    for k in range(HASH_W - 1, -1, -1):
        digits[:, :, k] = (x % ten).astype(np.uint8) + 48
        x //= ten
    line[:, -1] = ord("\n")
    return line


def write_query_file(path: str, rows, sets) -> None:
    with open(path, "w") as f:
        for r, hs in zip(rows, sets):
            f.write(f"ACC{int(r):07d}: " + " ".join(map(str, hs.tolist()))
                    + "\n")


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def phase_card(rec, run_chip_tests: bool = True):
    import jax
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip()
    print(f"card: {card}", flush=True)
    dev = jax.devices()[0]
    rec.update(card=card, device_kind=dev.device_kind,
               devices=len(jax.devices()), jax=jax.__version__,
               xla_flags=os.environ.get("XLA_FLAGS", ""),
               compile_cache=jax.config.jax_compilation_cache_dir)
    print(f"runtime: device_kind={dev.device_kind!r} "
          f"count={len(jax.devices())} jax={jax.__version__} "
          f"XLA_FLAGS={rec['xla_flags']!r}", flush=True)
    if not run_chip_tests:
        rec["ok"] = True
        return
    import pytest

    class Outcomes:
        passed = failed = skipped = 0

        def pytest_runtest_logreport(self, report):
            if report.skipped:
                self.skipped += 1
            elif report.failed:
                self.failed += 1
            elif report.when == "call":
                self.passed += 1

    seen = Outcomes()
    code = pytest.main(["-q", "-m", "chip", "-p", "no:cacheprovider",
                        os.path.join(REPO, "tests")], plugins=[seen])
    rec.update(chip_tests_passed=seen.passed, chip_tests_failed=seen.failed,
               chip_tests_skipped=seen.skipped)
    if code != 0 or seen.passed == 0 or seen.failed or seen.skipped:
        raise RuntimeError(f"chip tests: exit {int(code)}")
    rec["ok"] = True


def _db_rows(folder: str):
    with open(os.path.join(folder, "dtype.txt")) as f:
        dt = np.int16 if f.read().strip() == "int16" else np.int32
    with open(os.path.join(folder, "dimension.txt")) as f:
        d = int(f.read().strip())
    with open(os.path.join(folder, "vector_norms.txt")) as f:
        lines = [ln.rstrip("\n") for ln in f if ln.strip()]
    vec = np.fromfile(os.path.join(folder, "vectors.bin"), dtype=dt)
    vec = vec.reshape(len(lines), d)
    return {ln.split()[0]: (ln, vec[i].tobytes()) for i, ln in
            enumerate(lines)}


def phase_projection(rec, seed: int, log: str):
    from metagenome_vector_sketches_tpu.cli import project_everything
    from metagenome_vector_sketches_tpu.io.ingest import project_hash_lines
    from metagenome_vector_sketches_tpu.ops.projection import \
        project_host_many
    toy = os.path.join(REPO, "tests", "fixtures", "ref_toy")
    for fixture, extra in (("toy_db_2048", []),
                           ("toy_db_2048_i16", ["--int16"])):
        out = os.path.join(WORK, fixture)
        cli(project_everything.main,
            ["sketch", os.path.join(toy, "all_hashes_toy.txt"), out,
             "-d", D, *extra], log)
        ours, ref = _db_rows(out), _db_rows(os.path.join(toy, fixture))
        if ours != ref:
            bad = sorted(k for k in ref if ours.get(k) != ref[k])[:5]
            raise AssertionError(f"{fixture}: rows differ, e.g. {bad}")
        rec[f"{fixture}_accessions"] = len(ref)

    rng = np.random.default_rng([seed, 1])
    sizes = np.rint(10.0 ** rng.uniform(3, 6, 256)).astype(np.int64)
    sets = [np.unique(rng.integers(0, MAX_HASH, int(n), dtype=np.uint64))
            for n in sizes]
    t0 = time.perf_counter()
    vecs = project_hash_lines(sets, D, device="device")
    rec["heavy_tail_project_s"] = time.perf_counter() - t0
    rec["heavy_tail_hashes"] = int(sum(len(s) for s in sets))
    largest = int(np.argmax(sizes))
    others = rng.choice(np.delete(np.arange(256), largest), 7, replace=False)
    sample = sorted({largest, *map(int, others)})
    t0 = time.perf_counter()
    host = project_host_many([sets[i] for i in sample], D)
    rec["host_check_s"] = time.perf_counter() - t0
    if not np.array_equal(vecs[sample], host):
        raise AssertionError("device projection != host projection")
    rec["host_checked_rows"] = sample
    rec["largest_set"] = int(len(sets[largest]))
    rec["ok"] = True


def make_db(rec, data: PlantedData, log: str) -> str:
    from metagenome_vector_sketches_tpu.cli import project_everything
    hashes = os.path.join(WORK, "all_hashes.txt")
    t0 = time.perf_counter()
    size = data.write(hashes, workers=min(16, os.cpu_count() or 1))
    rec["gen_s"] = time.perf_counter() - t0
    print(f"  generated {size} bytes of hashes in {rec['gen_s']:.1f} s",
          flush=True)
    rec["hashes_file_bytes"] = size
    db = os.path.join(WORK, "db")
    t0 = time.perf_counter()
    cli(project_everything.main, ["sketch", hashes, db, "-d", D], log)
    rec["sketch_s"] = time.perf_counter() - t0
    os.remove(hashes)
    with open(os.path.join(db, "max_component.txt")) as f:
        rec["max_component"] = int(f.read())
    return db


def pairwise(db: str, out: str, log: str, mesh_devices: int) -> dict:
    from metagenome_vector_sketches_tpu.cli import pairwise_comp
    from metagenome_vector_sketches_tpu.matrix import compute as mc
    t0 = time.perf_counter()
    cli(pairwise_comp.main,
        ["--db", db, "--max_memory_gb", 64,
         "--num_threads", os.cpu_count() or 1, "--output_folder", out,
         "--num_shards", NUM_SHARDS, "--shard_idx", 0,
         "--mesh_devices", mesh_devices], log)
    wall = time.perf_counter() - t0
    stages = {k: v for k, v in mc.LAST_STAGES.items()
              if k != "dispatch_walls_ms"}
    walls = mc.LAST_STAGES.get("dispatch_walls_ms") or []
    stages["first_dispatch_ms"] = walls[0] if walls else None
    stages["later_dispatch_ms_median"] = \
        float(np.median(walls[1:])) if len(walls) > 1 else None
    mc.clear_device_cache()
    return {"wall_s": wall, "stages": stages}


def sweep_memory_analysis(n: int, L: int) -> dict:
    """compiled.memory_analysis() of the fused sweep program at the shape
    the engine dispatched (first chunk: the capacity floor)."""
    import jax
    import jax.numpy as jnp
    from metagenome_vector_sketches_tpu.matrix import compute as mc
    from metagenome_vector_sketches_tpu.ops import pairwise as pw
    tile = 2048
    npad = -(-n // tile) * tile
    P = pw.num_planes(L)
    cap = mc.FUSED_CAP_FLOOR
    K = min(mc.FUSED_CHUNK_TILES, (512 << 20) // ((P + 1) * 4 * cap))
    sds = jax.ShapeDtypeStruct
    planes = sds((P, npad, D), jnp.int8)
    thr = sds((npad,), jnp.float32)
    lowered = pw.sweep_extract_fused_ij.lower(
        planes, thr, planes, thr, sds((K, 3), jnp.int32),
        sds((K, 2), jnp.int32), tile, L, cap)
    ma = lowered.compile().memory_analysis()
    fields = ("argument_size_in_bytes", "output_size_in_bytes",
              "temp_size_in_bytes", "generated_code_size_in_bytes",
              "alias_size_in_bytes")
    out = {f: int(getattr(ma, f)) for f in fields if hasattr(ma, f)}
    out.update(tiles_per_dispatch=K, cap=cap, planes=P, npad=npad)
    return out


def phase_pairwise(rec, data: PlantedData, log: str) -> tuple[str, str]:
    from benchmarks.stream_scale import spot_check
    from metagenome_vector_sketches_tpu.matrix.reader import MatrixReader
    from metagenome_vector_sketches_tpu.ops import pairwise as pw
    n = data.N
    db = make_db(rec, data, log)
    mat = os.path.join(WORK, "mat")
    rows = -(-n // NUM_SHARDS)
    nt = -(-n // 2048)
    rt = -(-rows // 2048)
    rec["shard_rows"] = [0, rows - 1]
    rec["tiles"] = rt * (rt + 1) // 2 + rt * (nt - rt)
    rec["pairs"] = rows * n
    rec.update(pairwise(db, mat, log, mesh_devices=1))
    rec["pairs_per_s"] = rows * n / rec["wall_s"]
    L = pw.pick_limbs(rec["max_component"])
    rec["planes_bytes"] = pw.num_planes(L) * nt * 2048 * D
    rec["memory_analysis"] = sweep_memory_analysis(n, L)

    t0 = time.perf_counter()
    rec["spot_rows"] = 16
    ok = spot_check(db, mat, n, D, n_rows=16, seed=data.seed,
                    row_range=(0, rows))
    rec["spot_check_s"] = time.perf_counter() - t0
    if not ok:
        raise AssertionError("shard rows differ from the int64 oracle")
    planted = list(range(min(rows, data.grouped_end)))
    decoded = MatrixReader(mat).load_neighbors_for_rows(planted, n)
    found = sum(len(data.mates(r) & set(np.asarray(dec[0]).tolist()))
                for r, dec in zip(planted, decoded) if dec is not None)
    rec["planted_rows"] = len(planted)
    rec["planted_recall"] = found / (3 * len(planted))
    if rec["planted_recall"] != 1.0:
        raise AssertionError(f"planted recall {rec['planted_recall']}")
    rec["ok"] = True
    return db, mat


def phase_query(rec, data: PlantedData, db: str, mat: str, log: str):
    from metagenome_vector_sketches_tpu.cli import query_pc_mat
    rows_in_shard = -(-data.N // NUM_SHARDS)
    rng = np.random.default_rng([data.seed, 2])
    n_q = min(1000, min(rows_in_shard, data.grouped_end))
    rows = sorted(map(int, rng.choice(min(rows_in_shard, data.grouped_end),
                                      n_q, replace=False)))
    qdir = os.path.join(WORK, "topk")
    os.makedirs(qdir, exist_ok=True)
    qfile = os.path.join(WORK, "top_queries.txt")
    with open(qfile, "w") as f:
        f.writelines(f"ACC{r:07d}\n" for r in rows)
    t0 = time.perf_counter()
    cli(query_pc_mat.main,
        ["--matrix", mat, "--db", db, "--query_file", qfile, "--top", 10,
         "--batch_size", 1000, "--write_to_file",
         os.path.join(qdir, "out.csv")], log)
    rec["cli_s"] = time.perf_counter() - t0
    missing = 0
    for r in rows:
        with open(os.path.join(qdir, f"ACC{r:07d}_out.csv")) as f:
            got = {int(ln.split(",")[0][3:]) for ln in list(f)[1:]}
        missing += len(data.mates(r) - got)
    rec["queries"] = len(rows)
    rec["mates_missing"] = missing
    if missing:
        raise AssertionError(f"{missing} planted mates missing from top-10")
    rec["ok"] = True


def brute_force_cosines(db: str, q_int: np.ndarray) -> np.ndarray:
    """Exact cosines (N, B) of every db row against q_int: integer dots in
    float64 (exact: every |dot| here is far below 2^53), float64 division."""
    V = np.memmap(os.path.join(db, "vectors.bin"), dtype=np.int32, mode="r")
    V = V.reshape(-1, q_int.shape[1])
    Q = q_int.astype(np.float64)
    qn2 = np.einsum("ij,ij->i", Q, Q)
    out = np.empty((V.shape[0], len(Q)))
    for s in range(0, V.shape[0], 65536):
        blk = np.asarray(V[s:s + 65536], dtype=np.float64)
        vn2 = np.einsum("ij,ij->i", blk, blk)
        denom = np.sqrt(vn2[:, None] * qn2[None, :])
        with np.errstate(invalid="ignore", divide="ignore"):
            out[s:s + 65536] = np.where(denom > 0, (blk @ Q.T) / denom, 0.0)
    return out


def check_search(results, rows, data: PlantedData, db: str, q_int,
                 n_brute: int, ip_tol, rel: bool) -> dict:
    """Every query finds its group; the first n_brute queries' hits equal
    brute force (ids, and cosines within ip_tol) except for hits whose
    exact Jaccard lies within the tolerance of the threshold."""
    from metagenome_vector_sketches_tpu.io.dbfolder import DbFolder
    _, nn = DbFolder(db).names_and_norms()
    by_q: dict = {}
    for qi, name, jac in results:
        by_q.setdefault(qi, {})[int(name[3:])] = jac
    missing = sum(len(({r} | data.mates(r)) - set(by_q.get(i, {})))
                  for i, r in enumerate(rows))
    qs = (q_int[:n_brute].astype(np.float64) / np.sqrt(D)).astype(np.float32)
    qn = np.linalg.norm(qs, axis=1).astype(np.float64)
    cos = brute_force_cosines(db, q_int[:n_brute])
    worst_ip, boundary, id_diff = 0.0, 0, 0
    for i in range(n_brute):
        c, q = cos[:, i], qn[i]
        jac_ref = c * q * nn / (nn * nn + q * q - c * q * nn)
        want = set(np.flatnonzero(jac_ref > J_SEARCH).tolist())
        got = by_q.get(i, {})
        for r in want ^ set(got):
            tol = ip_tol * (abs(c[r]) if rel else 1.0)
            slope = q * nn[r] * (nn[r] ** 2 + q * q) / \
                (nn[r] ** 2 + q * q - c[r] * q * nn[r]) ** 2
            if abs(jac_ref[r] - J_SEARCH) <= 2 * tol * slope:
                boundary += 1
            else:
                id_diff += 1
        for r in want & set(got):
            jac = got[r]
            ip = jac * (nn[r] ** 2 + q * q) / (q * nn[r] * (1 + jac))
            err = abs(ip - c[r]) / (abs(c[r]) if rel else 1.0)
            worst_ip = max(worst_ip, err)
    out = {"queries": len(rows), "mates_missing": missing,
           "brute_force_queries": n_brute, "id_mismatches": id_diff,
           "boundary_ties": boundary,
           ("worst_rel_cos_err" if rel else "worst_abs_cos_err"): worst_ip,
           "cos_tol": ip_tol}
    if missing or id_diff or worst_ip > ip_tol:
        raise AssertionError(f"search differs from brute force: {out}")
    return out


def search_queries(data: PlantedData, n: int):
    from metagenome_vector_sketches_tpu.ops.projection import \
        project_host_many
    rng = np.random.default_rng([data.seed, 3])
    rows = sorted(map(int, rng.choice(data.grouped_end,
                                      min(n, data.grouped_end),
                                      replace=False)))
    sets = data.row_hashes(rows)
    qfile = os.path.join(WORK, "ann_queries.txt")
    write_query_file(qfile, rows, sets)
    return rows, qfile, project_host_many(sets, D)


def phase_ann(rec, data: PlantedData, db: str, log: str):
    from metagenome_vector_sketches_tpu.ann import search as ann_search
    from metagenome_vector_sketches_tpu.cli import jaccard
    t0 = time.perf_counter()
    cli(jaccard.main, ["index", db], log)
    rec["index_s"] = time.perf_counter() - t0
    rows, qfile, q_int = search_queries(data, 256)
    # f32: FAISS-parity float32 scores of unit vectors; the rounding bound
    # of a float32 dot over d terms (and of the two normalizations) is
    # gamma_{d+4} = (d+4)u/(1-(d+4)u), u = 2^-24, about 1.2e-4 at d=2048.
    # int8: float64 cosines of exact integer dots.
    u = 2.0 ** -24
    f32_tol = (D + 4) * u / (1 - (D + 4) * u)
    for engine, tol, rel in (("f32", f32_tol, False), ("int8", 1e-12, True)):
        t0 = time.perf_counter()
        cli(jaccard.main, ["search", db, qfile, "-j", J_SEARCH,
                           "--engine", engine], log)
        res = {"cli_s": time.perf_counter() - t0,
               "adaptive_stages": dict(ann_search.LAST_ADAPTIVE_STAGES)}
        t0 = time.perf_counter()
        out = ann_search.search_index(db, qfile, J_SEARCH, verbose=False,
                                      engine=engine)
        res["warm_search_s"] = time.perf_counter() - t0
        res.update(check_search(out, rows, data, db, q_int, 64, tol, rel))
        ann_search.clear_index_cache()
        rec[engine] = res
    rec["ok"] = True


def phase_four(rec, data: PlantedData, log: str):
    """Four cards against one: pairwise shard triples and int8 ANN."""
    from metagenome_vector_sketches_tpu.ann import search as ann_search
    from metagenome_vector_sketches_tpu.cli import jaccard
    from metagenome_vector_sketches_tpu.matrix.reader import MatrixReader
    db = make_db(rec, data, log)
    triples = {}
    for n in (4, 1):
        out = os.path.join(WORK, f"mat_mesh{n}")
        rec[f"pairwise_mesh{n}"] = pairwise(db, out, log, mesh_devices=n)
        r, c, q = MatrixReader(out).decode_all_triples(data.N)
        order = np.lexsort((c, r))
        triples[n] = (r[order], c[order], q[order])
    rec["triples"] = int(len(triples[1][0]))
    if not all(np.array_equal(a, b) for a, b in zip(triples[4], triples[1])):
        raise AssertionError("mesh-4 shard differs from mesh-1 shard")
    rows, qfile, _ = search_queries(data, 256)
    found = {}
    for n in (4, 1):
        t0 = time.perf_counter()
        cli(jaccard.main, ["search", db, qfile, "-j", J_SEARCH, "--engine",
                           "int8", "--mesh_devices", n], log)
        rec[f"search_mesh{n}_cli_s"] = time.perf_counter() - t0
        found[n] = ann_search.search_index(db, qfile, J_SEARCH,
                                           verbose=False, engine="int8",
                                           mesh_devices=n)
        ann_search.clear_index_cache()
    rec["hits"] = len(found[1])
    if found[4] != found[1]:
        raise AssertionError("mesh-4 search differs from mesh-1 search")
    rec["ok"] = True


def run(args, n: int = N) -> dict:
    """All phases over n accessions; raises on the first failure."""
    import jax
    phases = Phases()
    jax.monitoring.register_event_duration_secs_listener(phases.on_duration)
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    log = os.path.join(WORK, "cli.log")
    data = PlantedData(n, args.seed)
    print(f"sizes: N={n} d={D} int32, shard 0 of {NUM_SHARDS}; cut: "
          f"hash sets of {BASE} or {HEAVY} hashes (real sets hold thousands "
          f"to millions; phase b projects those)", flush=True)
    try:
        with phases.run("a_card") as rec:
            phase_card(rec, run_chip_tests=not args.four)
        if args.four:
            with phases.run("four_cards") as rec:
                phase_four(rec, data, log)
        else:
            with phases.run("b_projection") as rec:
                phase_projection(rec, args.seed, log)
            with phases.run("c_pairwise") as rec:
                db, mat = phase_pairwise(rec, data, log)
            with phases.run("d_query") as rec:
                phase_query(rec, data, db, mat, log)
            with phases.run("e_ann") as rec:
                phase_ann(rec, data, db, log)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    return phases.results


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--four", action="store_true",
                   help="compare a mesh of four GPUs with one GPU "
                        "(pairwise shard and int8 search) and nothing else")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    import jax
    if jax.default_backend() != "gpu":
        print(f"chip_smoke: JAX found no GPU (backend "
              f"{jax.default_backend()!r})", file=sys.stderr)
        return 2
    want = 4 if args.four else 1
    if len(jax.devices()) < want:
        print(f"chip_smoke: needs {want} GPUs, JAX sees "
              f"{len(jax.devices())}", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import metagenome_vector_sketches_tpu  # noqa: F401  (fails outside the repo)
    try:
        run(args)
    except Exception:
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
