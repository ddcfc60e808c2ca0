"""Device/host k-mer table property tests vs a python-dict ground truth —
the analog of the reference's multithreaded hash property test
(jellyfish unit_tests/test_hash_counter.cc:17-100): random keys, duplicate
inserts, accumulate, then compare every count."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from jasper_tpu.ops import codes
from jasper_tpu.ops.kmer import canonical_windows, words_per_kmer
from jasper_tpu.table import DeviceKmerTable, HostKmerTable, empty_table, insert_kmers, lookup_kmers
from jasper_tpu.table.kmer_table import slots_for, table_histogram, table_stats


def random_keys(rng, n, W, key_bits):
    """Random uint32 key words with the top word masked to valid bits."""
    keys = rng.integers(0, 2**32, size=(n, W), dtype=np.uint32)
    top_bits = key_bits - 32 * (W - 1)
    if top_bits < 32:
        keys[:, W - 1] &= (1 << top_bits) - 1
    return keys


@pytest.mark.parametrize("k", [11, 25, 37])
def test_insert_lookup_vs_dict(k):
    rng = np.random.default_rng(k)
    W = words_per_kmer(k)
    n_distinct = 2000
    pool = random_keys(rng, n_distinct, W, 2 * k)
    truth = {}
    tab = empty_table(k, slots_for(n_distinct))
    for batch in range(4):
        idx = rng.integers(0, n_distinct, size=3000)
        keys = pool[idx]
        counts = rng.integers(1, 5, size=3000).astype(np.uint32)
        active = rng.random(3000) < 0.9
        for i in range(3000):
            if active[i]:
                kk = keys[i].tobytes()
                truth[kk] = truth.get(kk, 0) + int(counts[i])
        tab, n_pending, _ = jax.jit(insert_kmers, donate_argnums=0)(
            tab, jnp.asarray(keys), jnp.asarray(counts), jnp.asarray(active)
        )
        assert int(n_pending) == 0

    # query all distinct + some absent keys
    absent = random_keys(rng, 500, W, 2 * k)
    q = np.concatenate([pool, absent])
    valid = np.ones(len(q), dtype=bool)
    got = np.asarray(jax.jit(lookup_kmers)(tab, jnp.asarray(q), jnp.asarray(valid)))
    for i in range(n_distinct):
        assert got[i] == truth.get(pool[i].tobytes(), 0)
    for i in range(500):
        assert got[n_distinct + i] == truth.get(absent[i].tobytes(), 0)

    # host mirror agrees
    host = HostKmerTable(k, np.asarray(tab))
    np.testing.assert_array_equal(host.lookup_words(q), got)

    # invalid lanes return 0
    got2 = np.asarray(
        jax.jit(lookup_kmers)(tab, jnp.asarray(q), jnp.zeros(len(q), dtype=bool))
    )
    assert (got2 == 0).all()


def test_table_overflow_reported():
    """More distinct keys than the whole probe chain (home bucket + pad
    buckets) can hold: the remainder must be reported pending."""
    from jasper_tpu.table.kmer_table import (
        PAD_BUCKETS,
        ROW_U32,
        slot_words_for,
    )

    k = 11
    slots = ROW_U32 // slot_words_for(words_per_kmer(k))
    tab = empty_table(k, slots)  # 1 home bucket + pad buckets
    capacity = (1 + PAD_BUCKETS) * slots
    n = capacity + 72
    rng = np.random.default_rng(0)
    keys = np.unique(random_keys(rng, n + 200, words_per_kmer(k), 2 * k), axis=0)[:n]
    counts = np.ones(n, dtype=np.uint32)
    tab, n_pending, placed = jax.jit(insert_kmers)(
        tab, jnp.asarray(keys), jnp.asarray(counts), jnp.ones(n, dtype=bool)
    )
    assert int(placed) == capacity
    assert int(n_pending) == n - capacity


def test_host_insert_matches_device():
    k = 21
    rng = np.random.default_rng(3)
    W = words_per_kmer(k)
    keys = random_keys(rng, 300, W, 2 * k)
    counts = rng.integers(1, 10, size=300).astype(np.uint32)

    tab = empty_table(k, 1024)
    tab, pend, _ = insert_kmers(tab, jnp.asarray(keys), jnp.asarray(counts), jnp.ones(300, bool))
    assert int(pend) == 0
    dev = HostKmerTable(k, np.asarray(tab))

    host = HostKmerTable.empty(k, 1024)
    host.insert_np(keys, counts)
    np.testing.assert_array_equal(
        host.lookup_words(keys), dev.lookup_words(keys)
    )


def test_query_codes_and_str():
    k = 7
    seq = "ACGTACGTTTGACGTACGGGNACGTACG"
    c = codes.encode(seq)
    keys, valid = canonical_windows(np, c, k)
    host = HostKmerTable.empty(k, 256)
    host.insert_np(keys[valid], np.ones(int(valid.sum()), dtype=np.uint32))
    q = host.query_codes(c)
    for i in range(len(seq) - k + 1):
        mer = seq[i : i + k]
        if "N" in mer:
            assert q[i] == 0
            assert host.query_str(mer) == 0
        else:
            assert q[i] >= 1
            assert host.query_str(mer) == q[i]
    assert host.query_str("ACG") == 0  # wrong length -> 0


def test_stats_and_histogram():
    k = 9
    host_keys = random_keys(np.random.default_rng(5), 100, words_per_kmer(k), 2 * k)
    counts = np.concatenate([np.ones(60), np.full(30, 2), np.full(10, 7)]).astype(np.uint32)
    tab = empty_table(k, 256)
    tab, pend, _ = insert_kmers(tab, jnp.asarray(host_keys), jnp.asarray(counts), jnp.ones(100, bool))
    assert int(pend) == 0
    uniq, distinct, total, mx = table_stats(tab, k)
    assert (int(uniq), int(distinct), int(total), int(mx)) == (60, 100, 60 + 60 + 70, 7)
    hist = np.asarray(table_histogram(tab, max_count=5, k=k))
    assert hist[1] == 60 and hist[2] == 30 and hist[5] == 10  # 7 clamps into bin 5
    assert hist[0] == 0


def test_lookup_pathological_skew_no_silent_zeros():
    """VERDICT r1 'silent-zero risk': with a tiny bucket count every key
    lives deep in the overflow cascade, and a large lookup batch floods the
    per-round compaction budget. Every lane must still resolve exactly."""
    from jasper_tpu.count.sorted_runs import run_from_keys
    from jasper_tpu.table.build import build_from_run
    from jasper_tpu.table.kmer_table import PAD_BUCKETS, lookup_kmers

    k = 9
    W = words_per_kmer(k)
    rng = np.random.default_rng(13)
    n_keys = 400  # 2 home buckets x 16 slots + deep spill into PAD buckets
    keys = random_keys(rng, 4096, W, 2 * k)
    keys = np.unique(keys, axis=0)[:n_keys]
    counts = rng.integers(1, 1000, size=n_keys).astype(np.uint32)
    h, rk, rc, n_act = run_from_keys(keys, counts, k)
    tab, n_failed = build_from_run(h, rk, rc, n_buckets=2)
    assert int(n_failed) == 0, "test setup: keys must fit 2+PAD buckets"

    oracle = {tuple(keys[i]): int(counts[i]) for i in range(n_keys)}
    B = 1 << 16  # >> per-round budget C; repeats of every key
    idx = rng.integers(0, n_keys, size=B)
    qk = keys[idx]
    got = np.asarray(lookup_kmers(tab, jnp.asarray(qk), jnp.ones(B, bool)))
    want = np.array([oracle[tuple(kk)] for kk in qk], dtype=np.uint32)
    assert (got == want).all()


@pytest.mark.parametrize("W", [2, 3])
@pytest.mark.parametrize("B", [256, 250])
def test_lookup_dense_table_overflow_chains_vs_host(W, B):
    """lookup_kmers on a dense table whose probe chains spill past home
    buckets into the PAD rows == HostKmerTable.lookup_words, for present
    keys, absent keys and invalid lanes."""
    from jasper_tpu.ops.hashing import hash_words_np, home_of
    from jasper_tpu.table.kmer_table import PAD_BUCKETS

    rng = np.random.default_rng(42 + W + B)
    k = 16 * W  # k only sets the word count here
    tab = empty_table(k, 1024)
    n_buckets = tab.shape[0] - PAD_BUCKETS
    S = HostKmerTable(k, np.asarray(tab)).slots
    pool = rng.integers(0, 2**32, size=(200_000, W), dtype=np.uint64).astype(
        np.uint32)
    pool_home = home_of(np, hash_words_np(pool), n_buckets)
    # 3 buckets' worth of keys homed on the last bucket spill into the PAD
    # rows; the rest fill the table to ~85%
    last = pool[pool_home == n_buckets - 1][: 3 * S]
    keys = np.concatenate([last, pool[pool_home < n_buckets - 1][:760]])
    n_keys = len(keys)
    counts = rng.integers(1, 1000, size=n_keys).astype(np.uint32)
    tab, n_pending, _ = insert_kmers(tab, jnp.asarray(keys),
                                     jnp.asarray(counts),
                                     jnp.ones(n_keys, bool))
    assert int(n_pending) == 0
    host = HostKmerTable(k, np.asarray(tab))
    assert host.tab[n_buckets + 1].any(), "no chain reaches the PAD rows"
    q = np.concatenate(
        [keys[rng.integers(0, n_keys, size=B // 2)],
         rng.integers(0, 2**32, size=(B - B // 2, W),
                      dtype=np.uint64).astype(np.uint32)])
    valid = rng.random(B) < 0.9
    got = np.asarray(lookup_kmers(tab, jnp.asarray(q), jnp.asarray(valid)))
    want = np.where(valid, host.lookup_words(q), 0)
    np.testing.assert_array_equal(got, want)
    assert (got[: B // 2][valid[: B // 2]] > 0).all()
