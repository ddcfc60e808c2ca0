#!/usr/bin/env python
"""Headline benchmark: device k-mer lookup throughput in the polishing scan.

Needs a GPU (exits non-zero without one). Prints ONE JSON line on stdout,
  {"metric": "kmer_lookups_per_sec", "value": N, "unit": "lookups/s",
   ..., "device": {...}}
and the run's details as one JSON line on stderr; both carry the device
as JAX reports it (platform, kind, count) and nvidia-smi's card name and
power limit.

The measured op is jasper_tpu.polish.window.scan_window — canonical window
extraction + batched HBM count-table probe + threshold classification — on a
realistic workload: a table holding the canonical 37-mers of a synthetic
genome, scanned over a mutated draft (~0.1% substitutions), so probes are a
mix of hits and misses like real polishing. Timed loops end in
jax.block_until_ready; the first call of each shape compiles outside them.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

GENOME_BASES = 4_000_000
LARGE_GENOME_BASES = 64_000_000  # race-scale lookup row: the production
#   DBs hold 55.7M-278M keys, where gather locality is worse than the
#   4M-key headline table — report both
TILE = 1 << 20  # windows per device call
COUNT_BASES = 32_000_000  # separate, larger input for the counting metric
COUNT_COVERAGES = (8, 32)  # report both
COUNT_ERR = 0.002  # read error rate: errors mint distinct singleton k-mers,
#                    which size the merge ladder
COUNT_CHUNK = 1 << 23  # bases per counting chunk (production default)
ITERS = 8
K = 37


def _make_reads_file(rng, coverage):
    """COUNT_BASES of 250 bp reads at `coverage` x over a fresh genome with
    COUNT_ERR random errors, written as FASTA — the production counting
    workload (duplicates collapse in the sorted-run dedupe; error singletons
    grow the distinct set like real sequencing data)."""
    import tempfile

    LUT = np.frombuffer(b"ACGT", dtype=np.uint8)
    g = rng.integers(0, 4, size=COUNT_BASES // coverage).astype(np.uint8)
    read_len = 250
    n_reads = COUNT_BASES // read_len
    starts = rng.integers(0, len(g) - read_len, size=n_reads)
    idx = starts[:, None] + np.arange(read_len)[None, :]
    mat = g[idx]
    emask = rng.random(mat.shape) < COUNT_ERR
    mat = np.where(emask, (mat + rng.integers(1, 4, size=mat.shape)) % 4, mat)
    mat = mat.astype(np.uint8)
    mat[1::2] = 3 - mat[1::2][:, ::-1]  # revcomp odd reads (code space)
    fd, path = tempfile.mkstemp(suffix=".fa", prefix="bench_reads_")
    with os.fdopen(fd, "wb") as f:
        txt = LUT[mat]
        for j in range(n_reads):
            f.write(b">r%d\n" % j)
            f.write(txt[j].tobytes())
            f.write(b"\n")
    return path


def main():
    import jax

    from jasper_tpu.utils.jaxenv import (
        gpu_devices,
        nvidia_smi,
        setup_compilation_cache,
    )

    try:
        devs = gpu_devices()
    except RuntimeError as e:
        print(f"bench.py: {e}", file=sys.stderr)
        return 1
    device = {"platform": devs[0].platform, "kind": devs[0].device_kind,
              "count": len(devs), "nvidia_smi": nvidia_smi()}
    setup_compilation_cache()

    import jax.numpy as jnp

    from jasper_tpu.count.sorted_runs import RunAccumulator, extract_windows
    from jasper_tpu.polish.window import scan_window
    from jasper_tpu.table.build import build_table

    rng = np.random.default_rng(0)
    genome = rng.integers(0, 4, size=GENOME_BASES).astype(np.uint8)

    @jax.jit
    def scan_step(tab, tile, thre):
        counts, below, rel = scan_window(tab, tile, thre, k=K)
        return counts.sum(dtype=jnp.uint32) ^ below.sum(dtype=jnp.uint32)

    # --- counting: the scatter-free sorted-run pipeline -----------------
    # Worst case (all-distinct genome, coverage 1 — every window is a new
    # key, maximal run growth) AND the production shape (COUNT_BASES of
    # read bases at COUNT_COVERAGE over a smaller genome, through the real
    # count_reads file path: parse + encode + count, like `jellyfish
    # count -C <file>` reference sub_commands/count_main.cc:218-385).
    def count_genome():
        acc = RunAccumulator(unit=max(1 << 14, COUNT_CHUNK // 8),
                             stage_lanes=8 * COUNT_CHUNK)
        for off in range(0, GENOME_BASES - K + 1, COUNT_CHUNK):
            end = min(off + COUNT_CHUNK + K - 1, GENOME_BASES)
            chunk = np.full(COUNT_CHUNK + K - 1, 4, dtype=np.uint8)
            chunk[: end - off] = genome[off:end]
            keys, valid = extract_windows(jnp.asarray(chunk), K)
            acc.push_raw(keys, valid)
        run = acc.finish()
        return build_table(run, K), int(run[3])

    t0 = time.time()
    tab, n_distinct = count_genome()
    jax.block_until_ready(tab)
    t_compile_build = time.time() - t0
    # steady state (cached compiles): count again into a fresh accumulator
    t0 = time.time()
    tab, n_distinct = count_genome()
    jax.block_until_ready(tab)
    t_build = time.time() - t0
    count_rate = GENOME_BASES / t_build

    # production-shaped counting: reads files at each reported coverage
    from jasper_tpu.count.counter import count_reads

    prod_rate_by_cov = {}
    t_prod_first = None
    for cov in COUNT_COVERAGES:
        reads_path = _make_reads_file(rng, cov)
        t0 = time.time()
        ptab = count_reads([reads_path], K, chunk_len=COUNT_CHUNK)
        jax.block_until_ready(ptab)
        if t_prod_first is None:
            t_prod_first = time.time() - t0
        t0 = time.time()
        ptab = count_reads([reads_path], K, chunk_len=COUNT_CHUNK)
        jax.block_until_ready(ptab)
        t_prod = time.time() - t0
        del ptab
        prod_rate_by_cov[cov] = COUNT_BASES / t_prod
        try:
            os.remove(reads_path)
        except OSError:
            pass
    prod_rate = prod_rate_by_cov[COUNT_COVERAGES[0]]
    from jasper_tpu.table.kmer_table import table_capacity

    n_slots = table_capacity(tab, K)

    # draft with ~0.1% substitutions
    draft = genome.copy()
    n_err = GENOME_BASES // 1000
    pos = rng.choice(GENOME_BASES, size=n_err, replace=False)
    draft[pos] = (draft[pos] + rng.integers(1, 4, size=n_err)) % 4

    tiles = [
        jnp.asarray(draft[off : off + TILE + K - 1])
        for off in range(0, min(4 * TILE, GENOME_BASES - TILE - K), TILE)
    ]
    thre = jnp.uint32(15)

    # warmup/compile + sync
    jax.block_until_ready(scan_step(tab, tiles[0], thre))

    t0 = time.time()
    n_lookups = 0
    out = None
    for it in range(ITERS):
        for tile in tiles:
            out = scan_step(tab, tile, thre)
            n_lookups += TILE
    jax.block_until_ready(out)
    dt = time.time() - t0
    rate = n_lookups / dt

    # --- race-scale lookup row: 64M-key table (worse gather locality) ----
    lg = np.frombuffer(rng.bytes(LARGE_GENOME_BASES), dtype=np.uint8) & 3
    acc = RunAccumulator(unit=max(1 << 14, COUNT_CHUNK // 8),
                         stage_lanes=8 * COUNT_CHUNK)
    for off in range(0, LARGE_GENOME_BASES - K + 1, COUNT_CHUNK):
        end = min(off + COUNT_CHUNK + K - 1, LARGE_GENOME_BASES)
        chunk = np.full(COUNT_CHUNK + K - 1, 4, dtype=np.uint8)
        chunk[: end - off] = lg[off:end]
        keys, valid = extract_windows(jnp.asarray(chunk), K)
        acc.push_raw(keys, valid)
    run = acc.finish()
    n_keys_large = int(run[3])
    tab_large = build_table(run, K)
    del run, acc
    jax.block_until_ready(tab_large)
    ldraft = lg.copy()
    n_err = LARGE_GENOME_BASES // 1000
    pos = rng.choice(LARGE_GENOME_BASES, size=n_err, replace=False)
    ldraft[pos] = (ldraft[pos] + rng.integers(1, 4, size=n_err)) % 4
    ltiles = [
        jnp.asarray(ldraft[off : off + TILE + K - 1])
        for off in range(0, 8 * TILE, TILE)
    ]
    jax.block_until_ready(scan_step(tab_large, ltiles[0], thre))  # warm
    t0 = time.time()
    n_lookups_l = 0
    for it in range(max(2, ITERS // 2)):
        for tile in ltiles:
            out = scan_step(tab_large, tile, thre)
            n_lookups_l += TILE
    jax.block_until_ready(out)
    dt_l = time.time() - t0
    rate_large = n_lookups_l / dt_l
    table_large_bytes = tab_large.nbytes
    del tab_large, ltiles

    meta = {
        "device": device,
        "k": K,
        "n_slots": n_slots,
        "n_keys": n_distinct,
        "build_secs": round(t_build, 2),
        "build_secs_first_incl_compile": round(t_compile_build, 2),
        "bases_counted_per_sec": round(prod_rate),
        "bases_counted_per_sec_by_coverage": {
            str(c): round(r) for c, r in prod_rate_by_cov.items()},
        "bases_counted_per_sec_all_distinct": round(count_rate),
        "count_bases": COUNT_BASES,
        "count_coverages": list(COUNT_COVERAGES),
        "count_read_error_rate": COUNT_ERR,
        "count_secs_first_incl_compile": round(t_prod_first, 2),
        "bench_secs": round(dt, 3),
        "tile_windows": TILE,
        "n_keys_large": n_keys_large,
        "table_large_bytes": table_large_bytes,
        "lookups_per_sec_large_table": round(rate_large),
    }
    print(json.dumps(meta), file=sys.stderr)
    print(
        json.dumps(
            {
                "metric": "kmer_lookups_per_sec",
                "value": round(rate),
                "unit": "lookups/s",
                "lookups_per_sec_large_table": round(rate_large),
                "n_keys_large_table": n_keys_large,
                "bases_counted_per_sec": round(prod_rate),
                "bases_counted_per_sec_by_coverage": {
                    str(c): round(r) for c, r in prod_rate_by_cov.items()},
                "bases_counted_per_sec_all_distinct": round(count_rate),
                "build_secs": round(t_build, 2),
                "device": device,
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
