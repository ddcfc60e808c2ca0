#!/usr/bin/env python
"""Profile the counting insert path on the real chip.

Separates compile time from steady-state, reports claim rounds per chunk and
the stage breakdown (extract+dedupe vs claim rounds), at two loads:
  * fresh table (all inserts are claims)
  * second pass over same data (all inserts are matches / count adds)

Usage: python tools/profile_count.py [n_bases] [chunk_log2]
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np

N_BASES = int(sys.argv[1]) if len(sys.argv) > 1 else 32_000_000
CHUNK = 1 << (int(sys.argv[2]) if len(sys.argv) > 2 else 22)
K = 37


def main():
    import jax

    from jasper_tpu.utils.jaxenv import setup_compilation_cache

    setup_compilation_cache()

    import jax.numpy as jnp

    from jasper_tpu.ops.kmer import canonical_windows
    from jasper_tpu.table.kmer_table import (
        _dedupe_sorted,
        empty_table,
        insert_kmers,
        slots_for,
    )

    print(f"device={jax.devices()[0]} n_bases={N_BASES} chunk={CHUNK}", file=sys.stderr)
    rng = np.random.default_rng(0)
    genome = rng.integers(0, 4, size=N_BASES).astype(np.uint8)

    @jax.jit
    def insert_step(tab, chunk):
        keys, valid = canonical_windows(jnp, chunk, K)
        tab, pend, placed, rounds = insert_kmers(
            tab, keys, jnp.full(keys.shape[0], 1, jnp.uint32), valid,
            with_rounds=True,
        )
        return tab, pend, placed, rounds

    @jax.jit
    def extract_dedupe_only(chunk):
        keys, valid = canonical_windows(jnp, chunk, K)
        k2, c2, a2 = _dedupe_sorted(keys, jnp.ones(keys.shape[0], jnp.uint32), valid)
        return k2.sum(dtype=jnp.uint32) ^ c2.sum(dtype=jnp.uint32)

    n_slots = slots_for(N_BASES, 0.6)
    tab = empty_table(K, n_slots)
    print(f"n_slots={n_slots} tab_bytes={tab.size * 4}", file=sys.stderr)

    chunks = []
    for off in range(0, N_BASES - K + 1, CHUNK):
        end = min(off + CHUNK + K - 1, N_BASES)
        c = np.full(CHUNK + K - 1, 4, dtype=np.uint8)
        c[: end - off] = genome[off:end]
        chunks.append(jnp.asarray(c))

    # compile
    t0 = time.time()
    tab2, pend, placed, rounds = insert_step(tab, chunks[0])
    pend, placed, rounds = int(pend), int(placed), int(rounds)
    t_compile = time.time() - t0
    print(f"insert compile+first: {t_compile:.1f}s rounds={rounds} placed={placed} pend={pend}",
          file=sys.stderr)

    t0 = time.time()
    np.asarray(extract_dedupe_only(chunks[0]))
    print(f"extract+dedupe compile+first: {time.time()-t0:.1f}s", file=sys.stderr)

    # steady state: extract+dedupe only
    t0 = time.time()
    for c in chunks[1:5]:
        out = extract_dedupe_only(c)
    np.asarray(out)
    dt_ed = (time.time() - t0) / max(1, len(chunks[1:5]))
    print(f"extract+dedupe steady: {dt_ed*1000:.1f} ms/chunk "
          f"({CHUNK/dt_ed/1e6:.1f} Mbases/s)", file=sys.stderr)

    # steady state: fresh-claim-heavy inserts (continue building)
    tab = tab2
    t0 = time.time()
    total_rounds = 0
    n = 0
    for c in chunks[1:]:
        tab, pend, placed, rounds = insert_step(tab, c)
        n += 1
    pend_v, rounds_v = int(pend), int(rounds)
    dt_ins = (time.time() - t0) / max(1, n)
    print(f"insert steady (claim-heavy): {dt_ins*1000:.1f} ms/chunk "
          f"({CHUNK/dt_ins/1e6:.1f} Mbases/s) last_rounds={rounds_v} pend={pend_v}",
          file=sys.stderr)

    # steady state: match-heavy inserts (second pass over same data)
    t0 = time.time()
    total_rounds = 0
    for c in chunks:
        tab, pend, placed, rounds = insert_step(tab, c)
    rounds_v = int(rounds)
    dt_m = (time.time() - t0) / len(chunks)
    print(f"insert steady (match-heavy): {dt_m*1000:.1f} ms/chunk "
          f"({CHUNK/dt_m/1e6:.1f} Mbases/s) last_rounds={rounds_v}", file=sys.stderr)

    import json
    print(json.dumps({
        "chunk": CHUNK,
        "n_slots": n_slots,
        "compile_secs": round(t_compile, 1),
        "extract_dedupe_ms": round(dt_ed * 1e3, 1),
        "insert_claim_ms": round(dt_ins * 1e3, 1),
        "insert_match_ms": round(dt_m * 1e3, 1),
        "bases_per_sec_claim": round(CHUNK / dt_ins),
        "bases_per_sec_match": round(CHUNK / dt_m),
    }))


def main_runs():
    """Profile the sorted-run counting pipeline (the production path)."""
    import jax

    from jasper_tpu.utils.jaxenv import setup_compilation_cache

    setup_compilation_cache()

    import jax.numpy as jnp

    from jasper_tpu.count.sorted_runs import (
        RunAccumulator,
        chunk_to_run,
        chunk_to_run_fast,
        extract_windows,
    )
    from jasper_tpu.table.build import build_table

    print(f"device={jax.devices()[0]} n_bases={N_BASES} chunk={CHUNK} "
          f"coverage={COVERAGE}", file=sys.stderr)
    rng = np.random.default_rng(0)
    if COVERAGE > 1:
        # realistic reads: sample windows of a genome at COVERAGE-fold depth
        gsize = max(CHUNK, N_BASES // COVERAGE)
        g = rng.integers(0, 4, size=gsize).astype(np.uint8)
        g = np.concatenate([g, g[:CHUNK]])  # wraparound sampling
        starts = rng.integers(0, gsize, size=-(-N_BASES // CHUNK))
        genome = np.concatenate([g[s : s + CHUNK] for s in starts])[:N_BASES]
    else:
        genome = rng.integers(0, 4, size=N_BASES).astype(np.uint8)
    chunks = []
    for off in range(0, N_BASES - K + 1, CHUNK):
        end = min(off + CHUNK + K - 1, N_BASES)
        c = np.full(CHUNK + K - 1, 4, dtype=np.uint8)
        c[: end - off] = genome[off:end]
        chunks.append(jnp.asarray(c))

    def one(acc, c):
        if MODE == "stage":
            keys, valid = extract_windows(c, K)
            acc.push_raw(keys, valid)
        elif MODE == "fast":
            h, kk, cc = chunk_to_run_fast(c, K)
            acc.push_uncompacted(h, kk, cc)
        else:
            r = chunk_to_run(c, K)
            acc.push(r[0], r[1], r[2], int(r[3]))

    def full_pass(acc):
        for c in chunks:
            one(acc, c)
        acc.flush_stage()
        jax.block_until_ready(list(acc.levels.values())[0][0])

    # warm pass: compiles every shape in the cascade
    t0 = time.time()
    acc = RunAccumulator(unit=max(1 << 14, CHUNK // 8), stage_lanes=8 * CHUNK)
    full_pass(acc)
    t_compile = time.time() - t0
    del acc
    print(f"warm pass (incl. compiles): {t_compile:.1f}s mode={MODE}",
          file=sys.stderr)

    # timed pass: warm cache
    acc = RunAccumulator(unit=max(1 << 14, CHUNK // 8), stage_lanes=8 * CHUNK)
    t0 = time.time()
    full_pass(acc)
    dt_push = time.time() - t0
    per_chunk = dt_push / max(1, len(chunks))
    print(f"push steady: {per_chunk*1000:.1f} ms/chunk "
          f"({CHUNK/per_chunk/1e6:.1f} Mbases/s) "
          f"resident={acc.n_resident_lanes()}", file=sys.stderr)

    t0 = time.time()
    run = acc.finish()
    jax.block_until_ready(run[0])
    dt_finish = time.time() - t0
    t0 = time.time()
    tab = build_table(run, K)
    jax.block_until_ready(tab)
    dt_build = time.time() - t0
    total = t_compile + dt_push + dt_finish + dt_build
    print(f"finish: {dt_finish:.2f}s build: {dt_build:.2f}s "
          f"n_active={run[3]} tab_MB={tab.size*4/1e6:.0f}", file=sys.stderr)

    import json
    print(json.dumps({
        "path": "sorted_runs",
        "chunk": CHUNK,
        "n_bases": N_BASES,
        "compile_secs": round(t_compile, 1),
        "push_ms_per_chunk": round(per_chunk * 1e3, 1),
        "finish_secs": round(dt_finish, 2),
        "build_secs": round(dt_build, 2),
        "distinct_keys": int(run[3]),
        "bases_per_sec_steady": round(CHUNK / per_chunk),
        "bases_per_sec_total_incl_compile": round(N_BASES / total),
        "bases_per_sec_total": round(N_BASES / (total - t_compile)),
    }))


COVERAGE = 1
MODE = "compact"

if __name__ == "__main__":
    if "--fast" in sys.argv:
        sys.argv.remove("--fast")
        MODE = "fast"
    if "--stage" in sys.argv:
        sys.argv.remove("--stage")
        MODE = "stage"
    if "--coverage" in sys.argv:
        i = sys.argv.index("--coverage")
        COVERAGE = int(sys.argv[i + 1])
        del sys.argv[i : i + 2]
    if "--runs" in sys.argv:
        sys.argv.remove("--runs")
        N_BASES = int(sys.argv[1]) if len(sys.argv) > 1 else 32_000_000
        CHUNK = 1 << (int(sys.argv[2]) if len(sys.argv) > 2 else 22)
        main_runs()
    else:
        main()
