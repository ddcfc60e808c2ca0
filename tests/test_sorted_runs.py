"""Property tests for the scatter-free counting core (sorted runs +
waterfall table build) against numpy oracles — the device analog of the
reference's ground-truth hash tests (jf:unit_tests/test_hash_counter.cc)."""

import jax.numpy as jnp
import numpy as np
import pytest

from jasper_tpu.count.sorted_runs import (
    RunAccumulator,
    chunk_to_run,
    merge_runs,
    run_from_keys,
)
from jasper_tpu.ops.kmer import canonical_windows, words_per_kmer
from jasper_tpu.table.build import build_from_run, build_table
from jasper_tpu.table.kmer_table import (
    PAD_BUCKETS,
    ROW_U32,
    lookup_kmers,
    slot_words_for,
)

K = 21


def _oracle_counts(codes: np.ndarray, k: int):
    keys, valid = canonical_windows(np, codes, k)
    keys = keys[valid]
    uniq, counts = np.unique(keys, axis=0, return_counts=True)
    return {tuple(u): int(c) for u, c in zip(uniq, counts)}


def _run_to_dict(h, keys, counts):
    h, keys, counts = np.asarray(h), np.asarray(keys), np.asarray(counts)
    act = counts > 0
    return {tuple(kk): int(c) for kk, c in zip(keys[act], counts[act])}


def test_chunk_to_run_matches_oracle():
    rng = np.random.default_rng(7)
    codes = rng.integers(0, 5, size=4096).astype(np.uint8)  # incl. N separators
    h, keys, counts, n_active = chunk_to_run(jnp.asarray(codes), K)
    oracle = _oracle_counts(codes, K)
    got = _run_to_dict(h, keys, counts)
    assert got == oracle
    assert int(n_active) == len(oracle)
    # actives form a prefix sorted by (h, key)
    act = np.asarray(counts) > 0
    assert act[: int(n_active)].all() and not act[int(n_active):].any()
    ha = np.asarray(h)[act]
    assert (np.diff(ha.astype(np.int64)) >= 0).all()


def test_merge_runs_sums_and_saturates():
    rng = np.random.default_rng(3)
    codes_a = rng.integers(0, 4, size=2048).astype(np.uint8)
    codes_b = np.concatenate([codes_a[:1024], rng.integers(0, 4, 1024).astype(np.uint8)])
    ra = chunk_to_run(jnp.asarray(codes_a), K)
    rb = chunk_to_run(jnp.asarray(codes_b), K)
    h, keys, counts, n_act = merge_runs(ra[0], ra[1], ra[2], rb[0], rb[1], rb[2])
    oracle = _oracle_counts(np.concatenate([codes_a, [4], codes_b]), K)
    assert _run_to_dict(h, keys, counts) == oracle
    assert int(n_act) == len(oracle)

    # saturation at uint32 max
    kk = np.asarray(ra[1])[:4].copy()
    hh = np.asarray(ra[0])[:4].copy()
    big = np.full(4, 0xFFFFFFF0, np.uint32)
    h2, k2, c2, _ = merge_runs(
        jnp.asarray(hh), jnp.asarray(kk), jnp.asarray(big),
        jnp.asarray(hh), jnp.asarray(kk), jnp.asarray(big),
    )
    act = np.asarray(c2) > 0
    assert (np.asarray(c2)[act] == 0xFFFFFFFF).all()


def test_accumulator_lsm_matches_oracle():
    rng = np.random.default_rng(11)
    chunks = [rng.integers(0, 4, size=1 << 10).astype(np.uint8) for _ in range(9)]
    acc = RunAccumulator(unit=256)
    for c in chunks:
        h, keys, counts, n = chunk_to_run(jnp.asarray(c), K)
        acc.push(h, keys, counts, int(n))
    h, keys, counts, n_active = acc.finish()
    all_codes = np.concatenate([np.concatenate([c, [4]]) for c in chunks]).astype(np.uint8)
    oracle = _oracle_counts(all_codes, K)
    assert _run_to_dict(h, keys, counts) == oracle
    assert int(n_active) == len(oracle)


def test_build_from_run_lookup_exact():
    rng = np.random.default_rng(5)
    codes = rng.integers(0, 4, size=1 << 14).astype(np.uint8)
    run = chunk_to_run(jnp.asarray(codes), K)
    tab = build_table((run[0], run[1], run[2], int(run[3])), K)
    oracle = _oracle_counts(codes, K)

    keys, valid = canonical_windows(np, codes, K)
    got = np.asarray(lookup_kmers(tab, jnp.asarray(keys), jnp.asarray(valid)))
    for i in range(len(keys)):
        if valid[i]:
            assert got[i] == oracle[tuple(keys[i])]

    # absent keys return 0
    other = rng.integers(0, 4, size=4096).astype(np.uint8)
    okeys, ovalid = canonical_windows(np, other, K)
    got2 = np.asarray(lookup_kmers(tab, jnp.asarray(okeys), jnp.asarray(ovalid)))
    for i in range(len(okeys)):
        if ovalid[i]:
            assert got2[i] == oracle.get(tuple(okeys[i]), 0)


def test_build_from_run_overflow_reported():
    # 1-bucket table cannot hold thousands of keys: n_failed must say so
    rng = np.random.default_rng(9)
    codes = rng.integers(0, 4, size=1 << 13).astype(np.uint8)
    h, keys, counts, n = chunk_to_run(jnp.asarray(codes), K)
    _, n_failed = build_from_run(h, keys, counts, n_buckets=1)
    sw = slot_words_for(words_per_kmer(K))
    cap = (1 + PAD_BUCKETS) * (ROW_U32 // sw)
    assert int(n_failed) >= int(n) - cap > 0


def test_run_from_keys_roundtrip():
    rng = np.random.default_rng(2)
    codes = rng.integers(0, 4, size=2048).astype(np.uint8)
    oracle = _oracle_counts(codes, K)
    keys = np.array(sorted(oracle), dtype=np.uint32)
    counts = np.array([oracle[tuple(kk)] for kk in keys], dtype=np.uint32)
    h, k2, c2, n = run_from_keys(keys, counts, K)
    assert _run_to_dict(h, k2, c2) == oracle
    assert int(n) == len(oracle)


def test_fast_uncompacted_path_matches_oracle():
    """chunk_to_run_fast + push_uncompacted (the counting hot path: one
    sort, interspersed dead lanes, no device sync) must produce the same
    table contents as the oracle."""
    from jasper_tpu.count.sorted_runs import chunk_to_run_fast

    rng = np.random.default_rng(23)
    chunks = [rng.integers(0, 5, size=1 << 11).astype(np.uint8) for _ in range(7)]
    acc = RunAccumulator(unit=512)
    for c in chunks:
        h, keys, counts = chunk_to_run_fast(jnp.asarray(c), K)
        acc.push_uncompacted(h, keys, counts)
    h, keys, counts, n_active = acc.finish()
    all_codes = np.concatenate([np.concatenate([c, [4]]) for c in chunks]).astype(np.uint8)
    oracle = _oracle_counts(all_codes, K)
    assert _run_to_dict(h, keys, counts) == oracle
    assert int(n_active) == len(oracle)

    # and the built table answers exactly
    tab = build_table((h, keys, counts, int(n_active)), K)
    qk = np.array(sorted(oracle), dtype=np.uint32)
    got = np.asarray(lookup_kmers(tab, jnp.asarray(qk), jnp.ones(len(qk), bool)))
    want = np.array([oracle[tuple(x)] for x in qk], np.uint32)
    np.testing.assert_array_equal(got, want)


def test_large_k_table_roundtrip():
    """k > 112 (sw=16 slot layout, VERDICT r1 minor gap): counts exact."""
    from jasper_tpu.count.sorted_runs import chunk_to_run

    k = 127
    rng = np.random.default_rng(3)
    codes = rng.integers(0, 4, size=4096).astype(np.uint8)
    run = chunk_to_run(jnp.asarray(codes), k)
    tab = build_table((run[0], run[1], run[2], int(run[3])), k)
    oracle = _oracle_counts(codes, k)
    keys, valid = canonical_windows(np, codes, k)
    got = np.asarray(lookup_kmers(tab, jnp.asarray(keys), jnp.asarray(valid)))
    for i in range(len(keys)):
        if valid[i]:
            assert got[i] == oracle[tuple(keys[i])]


def test_single_uncompacted_run_builds_gap_free():
    """Regression: one uncompacted chunk run (dead duplicate lanes
    interspersed) built at HIGH load must not open empty-slot gaps inside
    probe cascades (all lookups exact, including deep-cascade keys)."""
    from jasper_tpu.count.sorted_runs import chunk_to_run_fast

    rng = np.random.default_rng(31)
    # heavy duplication: small alphabet region repeated
    base = rng.integers(0, 4, size=512).astype(np.uint8)
    codes = np.concatenate([base] * 8 + [rng.integers(0, 4, size=2048).astype(np.uint8)])
    h, keys, counts = chunk_to_run_fast(jnp.asarray(codes), K)
    n_active = int(jnp.sum(counts > 0))
    # force long cascades: tiny bucket count (high load)
    sw = slot_words_for(words_per_kmer(K))
    S = ROW_U32 // sw
    n_buckets = max(1, (n_active // S) // 4)
    n_buckets = 1 << max(0, (n_buckets - 1).bit_length())
    tab, n_failed = build_from_run(h, keys, counts, n_buckets=n_buckets)
    while int(n_failed) > 0:
        n_buckets *= 2
        tab, n_failed = build_from_run(h, keys, counts, n_buckets=n_buckets)
    oracle = _oracle_counts(codes, K)
    qk = np.array(sorted(oracle), dtype=np.uint32)
    got = np.asarray(lookup_kmers(tab, jnp.asarray(qk), jnp.ones(len(qk), bool)))
    want = np.array([oracle[tuple(x)] for x in qk], np.uint32)
    np.testing.assert_array_equal(got, want)


def test_push_raw_staging_matches_oracle():
    """push_raw staging (the production count_reads path: raw window keys
    batched into one compacted sort per stage) must equal the oracle,
    including a partial final stage flushed by finish()."""
    from jasper_tpu.count.sorted_runs import extract_windows

    rng = np.random.default_rng(29)
    chunks = [rng.integers(0, 5, size=1 << 11).astype(np.uint8) for _ in range(7)]
    acc = RunAccumulator(unit=512, stage_lanes=3 * (1 << 11))
    for c in chunks:
        keys, valid = extract_windows(jnp.asarray(c), K)
        acc.push_raw(keys, valid)
    h, keys, counts, n_active = acc.finish()
    all_codes = np.concatenate([np.concatenate([c, [4]]) for c in chunks]).astype(np.uint8)
    oracle = _oracle_counts(all_codes, K)
    assert _run_to_dict(h, keys, counts) == oracle
    assert int(n_active) == len(oracle)
