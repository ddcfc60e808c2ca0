"""Counting pipeline vs a pure-python oracle (the analog of the reference's
golden histogram tests, jellyfish tests/parallel_hashing.sh: same counts
regardless of chunking)."""

import gzip

import numpy as np
import pytest

from jasper_tpu.count.counter import count_reads, count_sequences
from jasper_tpu.count.histogram import histogram_rows, threshold_from_histogram
from jasper_tpu.io.fastx import iter_reads, read_fasta, stream_codes, write_fasta
from jasper_tpu.ops.codes import canonical_str
from jasper_tpu.table import HostKmerTable


def oracle_counts(seqs, k):
    d = {}
    for s in seqs:
        for i in range(len(s) - k + 1):
            mer = s[i : i + k]
            if any(c not in "ACGTacgt" for c in mer):
                continue
            c = canonical_str(mer)
            d[c] = d.get(c, 0) + 1
    return d


def check_table_matches(tab_dev, k, truth):
    host = HostKmerTable(k, np.asarray(tab_dev))
    keys, counts = host.items()
    assert len(keys) == len(truth)
    got = {}
    from jasper_tpu.ops.kmer import int_to_kmer, words_to_int

    for i in range(len(keys)):
        got[int_to_kmer(words_to_int(keys[i]), k)] = int(counts[i])
    assert got == truth


@pytest.mark.parametrize("k", [7, 25])
def test_count_sequences_vs_oracle(k):
    rng = np.random.default_rng(k)
    seqs = [
        "".join(rng.choice(list("ACGTN"), p=[0.24, 0.24, 0.24, 0.24, 0.04]) for _ in range(rng.integers(k - 3, 200)))
        for _ in range(50)
    ]
    tab = count_sequences(seqs, k, n_slots=1 << 14)
    check_table_matches(tab, k, oracle_counts(seqs, k))


def test_count_reads_chunked_fastq_gz(tmp_path):
    """Small chunk_len forces many seams; counts must not change."""
    k = 11
    rng = np.random.default_rng(1)
    reads = ["".join(rng.choice(list("ACGT")) for _ in range(rng.integers(20, 90))) for _ in range(120)]
    fq = tmp_path / "reads.fastq.gz"
    with gzip.open(fq, "wt") as f:
        for i, r in enumerate(reads):
            f.write(f"@r{i} extra\n{r}\n+\n{'I' * len(r)}\n")
    tab = count_reads([str(fq)], k, n_slots=1 << 14, chunk_len=256)
    check_table_matches(tab, k, oracle_counts(reads, k))


def test_iter_reads_fasta_multiline(tmp_path):
    fa = tmp_path / "r.fa"
    fa.write_text(">a desc\nACGT\nACGT\n>b\nGGGG\n>empty\n>c\nTT\n")
    assert list(iter_reads(str(fa))) == ["ACGTACGT", "GGGG", "", "TT"]


def test_read_write_fasta_roundtrip(tmp_path):
    seqs = {"ctg1": "ACGT" * 40, "ctg2": "A" * 61, "ctg3": ""}
    p = tmp_path / "x.fa"
    write_fasta(str(p), seqs)
    back = read_fasta(str(p))
    assert back == seqs
    # 60-col wrapping
    lines = p.read_text().splitlines()
    assert max(len(l) for l in lines) == 60  # seq lines wrapped at 60
    assert lines[1] == "ACGT" * 15


def test_stream_codes_covers_all_kmers(tmp_path):
    k = 9
    rng = np.random.default_rng(2)
    reads = ["".join(rng.choice(list("ACGT")) for _ in range(30)) for _ in range(40)]
    fa = tmp_path / "r.fa"
    with open(fa, "w") as f:
        for i, r in enumerate(reads):
            f.write(f">r{i}\n{r}\n")
    truth = oracle_counts(reads, k)
    from jasper_tpu.ops.kmer import canonical_windows, int_to_kmer, words_to_int

    got = {}
    for codes, fill in stream_codes([str(fa)], k, chunk_len=64):
        keys, valid = canonical_windows(np, codes, k)
        for i in range(len(valid)):
            if valid[i]:
                mer = int_to_kmer(words_to_int(keys[i]), k)
                got[mer] = got.get(mer, 0) + 1
    assert got == truth


def test_threshold_walk():
    # descending then rising: local min at bin 8 -> threshold 4
    rows = [(1, 1000), (2, 500), (4, 100), (8, 40), (9, 90)]
    assert threshold_from_histogram(rows) == 4
    # local min too low
    assert threshold_from_histogram([(1, 100), (2, 50), (3, 80)]) is None
    # monotonic: never rises
    assert threshold_from_histogram([(1, 100), (2, 50), (3, 10)]) is None
    # flat continues descent (count >= freq)
    rows = [(1, 100), (5, 50), (6, 50), (10, 60)]
    assert threshold_from_histogram(rows) == 3


def test_histogram_rows_from_table():
    k = 7
    seqs = ["ACGTACGTACGT"]
    tab = count_sequences(seqs, k, n_slots=256)
    rows = histogram_rows(tab, k)
    truth = oracle_counts(seqs, k)
    import collections

    freq = collections.Counter(truth.values())
    assert rows == sorted((c, n) for c, n in freq.items())


@pytest.mark.slow
def test_mesh_counting_jf_byte_match(tmp_path):
    """Multi-chip counting (count_reads mesh=8-virtual-device "data" mesh,
    count/mesh_runs.py) must produce a table whose .jf dump byte-matches the
    single-device stream's — VERDICT r2 #2. Small chunk_len forces many
    chunk groups (including a final partial group with sentinel padding)."""
    import jax
    from jax.sharding import Mesh

    from jasper_tpu.io.jf import dump_table_to_jf

    k = 17
    rng = np.random.default_rng(23)
    reads = [
        "".join(rng.choice(list("ACGTN"), p=[0.245, 0.245, 0.245, 0.245, 0.02])
                for _ in range(rng.integers(40, 180)))
        for _ in range(300)
    ]
    fq = tmp_path / "reads.fq"
    with open(fq, "w") as f:
        for i, r in enumerate(reads):
            f.write(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n")

    tab1 = count_reads([str(fq)], k, chunk_len=2048)
    mesh = Mesh(np.array(jax.devices()[:8]), ("data",))
    tab8 = count_reads([str(fq)], k, chunk_len=2048, mesh=mesh)

    p1 = tmp_path / "one.jf"
    p8 = tmp_path / "eight.jf"
    dump_table_to_jf(str(p1), HostKmerTable(k, np.asarray(tab1)))
    dump_table_to_jf(str(p8), HostKmerTable(k, np.asarray(tab8)))
    # headers may differ in creation time; records must byte-match (the
    # 9-digit header length prefix locates the record section)
    def records(p):
        with open(p, "rb") as f:
            hlen = int(f.read(9))
            f.seek(9 + hlen)
            return f.read()

    rec1 = records(p1)
    rec8 = records(p8)
    assert rec1 == rec8
    assert len(rec1) > 0
    # and the oracle agrees
    check_table_matches(tab8, k, oracle_counts(reads, k))


@pytest.mark.slow
@pytest.mark.parametrize("k", [301, 520])  # W=19 (sw=32) and W=33 (sw=64)
def test_count_wide_k_beyond_240(k, tmp_path):
    """k > 240 (reference multi-word mers are unbounded,
    jf:include/jellyfish/mer_dna.hpp:626-667): the full cycle — count,
    host-table items, string queries through CountSource (native kernel
    serves W <= 63 since r4; beyond that it falls back), and .jf
    round-trip."""
    rng = np.random.default_rng(k)
    seqs = [
        "".join(rng.choice(list("ACGT")) for _ in range(rng.integers(k, k + 80)))
        for _ in range(6)
    ]
    seqs.append(seqs[0])  # duplicate => counts of 2
    tab = count_sequences(seqs, k, n_slots=1 << 10)
    truth = oracle_counts(seqs, k)
    check_table_matches(tab, k, truth)

    host = HostKmerTable(k, np.asarray(tab))
    from jasper_tpu.polish.engine import CountSource

    src = CountSource(host)
    from jasper_tpu.table import native_table

    if native_table.available():
        # jt_table.cc MAX_W=63 (r4): wide-k queries run native, no
        # pure-Python fallback cliff during repair
        assert src._native is not None
    some = list(truth.items())[:5]
    for mer, cnt in some:
        assert src.count(mer) == cnt
    assert src.count("A" * k) == truth.get("A" * k, 0)
    # native and pure-Python paths agree on adversarial strings
    if src._native is not None:
        from jasper_tpu.polish.semantics import effective_canonical_words

        for s in [seqs[0][:k], "N" + seqs[1][:k], seqs[2][: k - 7], "A" * k]:
            want = host.lookup_words(
                np.asarray(effective_canonical_words(s, k))[None])[0]
            assert src._native.query_str(s) == int(want)

    from jasper_tpu.io.jf import dump_table_to_jf, load_jf_into_host_table

    p = str(tmp_path / "wide.jf")
    dump_table_to_jf(p, host)
    host2, header = load_jf_into_host_table(p)
    keys, counts = host.items()
    keys2, counts2 = host2.items()
    assert np.array_equal(np.sort(counts), np.sort(counts2))
    assert host2.k == k


def test_host_finish_matches_device_finish(tmp_path):
    """count_reads_to_host's chromosome-scale finish (per-level pulls +
    native host k-way merge, forced via scale_finish_lanes=0) must produce
    the same table items and the same .jf bytes as the device merge-all
    finish — the reference analog is merge_files equivalence
    (jf:tests/merge.sh: direct count == merged count)."""
    from jasper_tpu.count.counter import count_reads_to_host
    from jasper_tpu.io.jf import dump_table_to_jf

    k = 15
    rng = np.random.default_rng(77)
    reads = [
        "".join(rng.choice(list("ACGTN"), p=[0.245, 0.245, 0.245, 0.245, 0.02])
                for _ in range(rng.integers(40, 160)))
        for _ in range(250)
    ]
    fq = tmp_path / "r.fq"
    with open(fq, "w") as f:
        for i, r in enumerate(reads):
            f.write(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n")

    # tiny chunks force many stage flushes and several LSM levels
    tab_dev, k1, c1 = count_reads_to_host([str(fq)], k, chunk_len=1024)
    tab_host, k2, c2 = count_reads_to_host([str(fq)], k, chunk_len=1024,
                                           scale_finish_lanes=0)
    assert np.array_equal(k1, k2)
    assert np.array_equal(c1, c2)
    assert np.array_equal(tab_dev.tab, tab_host.tab)
    check_table_matches(tab_host.tab, k, oracle_counts(reads, k))

    p1, p2 = tmp_path / "a.jf", tmp_path / "b.jf"
    dump_table_to_jf(str(p1), tab_dev)
    dump_table_to_jf(str(p2), tab_host)

    def records(p):
        with open(p, "rb") as f:
            hlen = int(f.read(9))
            f.seek(9 + hlen)
            return f.read()

    assert records(p1) == records(p2)


def test_host_finish_mesh_matches(tmp_path):
    """The host-merge finish over a mesh accumulator (per-device per-level
    streams) must match the single-device result."""
    import jax
    from jax.sharding import Mesh

    from jasper_tpu.count.counter import count_reads_to_host

    k = 13
    rng = np.random.default_rng(31)
    reads = [
        "".join(rng.choice(list("ACGT")) for _ in range(rng.integers(30, 120)))
        for _ in range(200)
    ]
    fq = tmp_path / "r.fq"
    with open(fq, "w") as f:
        for i, r in enumerate(reads):
            f.write(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n")

    _, k1, c1 = count_reads_to_host([str(fq)], k, chunk_len=1024)
    mesh = Mesh(np.array(jax.devices()[:4]), ("data",))
    _, k2, c2 = count_reads_to_host([str(fq)], k, chunk_len=1024, mesh=mesh,
                                    scale_finish_lanes=0)
    assert np.array_equal(k1, k2)
    assert np.array_equal(c1, c2)


def test_eviction_overlap_matches(tmp_path):
    """Mid-count level eviction (async pulls overlapped with counting,
    scale_finish_lanes=0 => evict constantly) must produce the identical
    distinct set as the classic device finish."""
    from jasper_tpu.count.counter import count_reads_to_host

    k = 15
    rng = np.random.default_rng(6)
    reads = [
        "".join(rng.choice(list("ACGT")) for _ in range(rng.integers(40, 140)))
        for _ in range(300)
    ]
    fq = tmp_path / "r.fq"
    with open(fq, "w") as f:
        for i, r in enumerate(reads):
            f.write(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n")
    logs = []
    _, k1, c1 = count_reads_to_host([str(fq)], k, chunk_len=1024)
    _, k2, c2 = count_reads_to_host([str(fq)], k, chunk_len=1024,
                                    scale_finish_lanes=0, tlog=logs.append)
    assert any("eviction started" in l for l in logs)
    assert np.array_equal(k1, k2)
    assert np.array_equal(c1, c2)


def _write_fq(tmp_path, reads, name="r.fq"):
    fq = tmp_path / name
    with open(fq, "w") as f:
        for i, r in enumerate(reads):
            f.write(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n")
    return str(fq)


def test_partitioned_counting_matches(tmp_path, monkeypatch):
    """Single-pass hash-partitioned counting (JT_COUNT_PARTITIONS=4: one
    extraction, P per-partition ladders) must produce the identical record
    stream and host table as the unpartitioned path — reference analog:
    jellyfish --disk bounded-memory counting equals direct counting
    (jf:tests/merge.sh)."""
    from jasper_tpu.count.counter import count_reads_to_host

    k = 15
    rng = np.random.default_rng(12)
    reads = [
        "".join(rng.choice(list("ACGTN"), p=[0.245, 0.245, 0.245, 0.245, 0.02])
                for _ in range(rng.integers(40, 150)))
        for _ in range(250)
    ]
    fq = _write_fq(tmp_path, reads)

    t1, k1, c1 = count_reads_to_host([fq], k, chunk_len=1024)
    logs = []
    monkeypatch.setenv("JT_COUNT_PARTITIONS", "4")
    t2, k2, c2 = count_reads_to_host([fq], k, chunk_len=1024,
                                     tlog=logs.append)
    assert any("4 ladders" in l for l in logs), logs
    assert np.array_equal(k1, k2)
    assert np.array_equal(c1, c2)
    assert np.array_equal(t1.tab, t2.tab)


def test_grouped_partitioned_counting_matches(tmp_path, monkeypatch):
    """G=2 grouped passes (half the hash space resident per pass) must
    reproduce the unpartitioned stream and host table exactly."""
    from jasper_tpu.count.counter import count_reads_to_host

    k = 15
    rng = np.random.default_rng(7)
    reads = ["".join(rng.choice(list("ACGT")) for _ in range(130))
             for _ in range(220)]
    fq = _write_fq(tmp_path, reads)
    t1, k1, c1 = count_reads_to_host([fq], k, chunk_len=1024)
    logs = []
    monkeypatch.setenv("JT_COUNT_PARTITIONS", "4")
    monkeypatch.setenv("JT_COUNT_GROUPS", "2")
    t2, k2, c2 = count_reads_to_host([fq], k, chunk_len=1024,
                                     tlog=logs.append)
    assert any("pass 2/2 counted" in l for l in logs), logs
    assert np.array_equal(k1, k2)
    assert np.array_equal(c1, c2)
    assert np.array_equal(t1.tab, t2.tab)


def test_partitioned_multipass_matches(tmp_path, monkeypatch):
    """The P-pass extraction-filter path (the mesh / overflow-fallback
    regime) must also reproduce the unpartitioned stream, with and without
    the RAM codes cache."""
    from jasper_tpu.count import counter

    k = 15
    rng = np.random.default_rng(12)
    reads = ["".join(rng.choice(list("ACGT")) for _ in range(120))
             for _ in range(200)]
    fq = _write_fq(tmp_path, reads)
    _, k1, c1 = counter.count_reads_to_host([fq], k, chunk_len=1024)
    logs = []
    _, k2, c2 = counter._count_partitioned(
        [fq], k, 4, None, 1024, 1 << 23, True, None, None, logs.append)
    assert any("partition pass 4/4" in l for l in logs), logs
    assert np.array_equal(k1, k2) and np.array_equal(c1, c2)
    monkeypatch.setenv("JT_CODES_CACHE_BYTES", "0")
    _, k3, c3 = counter._count_partitioned(
        [fq], k, 4, None, 1024, 1 << 23, True, None, None, lambda *_: None)
    assert np.array_equal(k1, k3) and np.array_equal(c1, c3)


def test_partition_slice_overflow_falls_back(tmp_path, monkeypatch):
    """A partition slice overflow (forced by a 1-lane slice capacity) must
    fall back to the P-pass filter and still produce exact results."""
    from jasper_tpu.count import counter
    from jasper_tpu.count import sorted_runs

    k = 15
    rng = np.random.default_rng(5)
    reads = ["".join(rng.choice(list("ACGT")) for _ in range(100))
             for _ in range(120)]
    fq = _write_fq(tmp_path, reads)
    _, k1, c1 = counter.count_reads_to_host([fq], k, chunk_len=1024)

    orig_init = sorted_runs.PartitionedRunAccumulator.__init__

    def tiny_init(self, P, unit, stage_lanes, slice_cap=None, p0=0,
                  bits_total=None):
        orig_init(self, P, unit, stage_lanes, slice_cap=64, p0=p0,
                  bits_total=bits_total)

    monkeypatch.setattr(sorted_runs.PartitionedRunAccumulator, "__init__",
                        tiny_init)
    monkeypatch.setenv("JT_COUNT_PARTITIONS", "2")
    logs = []
    _, k2, c2 = counter.count_reads_to_host([fq], k, chunk_len=1024,
                                            tlog=logs.append)
    assert any("slice overflow" in l for l in logs), logs
    assert np.array_equal(k1, k2) and np.array_equal(c1, c2)


def test_device_table_matches_host_table(tmp_path):
    """The classic finish's device-built scan table must equal the
    host-built table bit-for-bit (the polish scan reads the device copy,
    the repair path reads the host copy — byte parity requires identical
    lookups)."""
    from jasper_tpu.count.counter import count_reads_to_host

    k = 15
    rng = np.random.default_rng(44)
    reads = ["".join(rng.choice(list("ACGT")) for _ in range(120))
             for _ in range(150)]
    fq = tmp_path / "r.fq"
    with open(fq, "w") as f:
        for i, r in enumerate(reads):
            f.write(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n")
    host, _, _, dev = count_reads_to_host([str(fq)], k, chunk_len=2048,
                                          return_device_table=True)
    assert dev is not None
    np.testing.assert_array_equal(np.asarray(dev), host.tab)


def test_partitioned_valve_eviction_matches(tmp_path, monkeypatch):
    """The partitioned path's ladder-eviction safety valve (fires when the
    resident ladders outgrow the device budget) must not change results."""
    from jasper_tpu.count import counter

    k = 15
    rng = np.random.default_rng(19)
    reads = ["".join(rng.choice(list("ACGT")) for _ in range(100))
             for _ in range(200)]
    fq = _write_fq(tmp_path, reads)
    _, k1, c1 = counter.count_reads_to_host([str(fq)], k, chunk_len=1024)
    logs = []
    monkeypatch.setenv("JT_COUNT_PARTITIONS", "2")
    monkeypatch.setenv("JT_PARTITION_RESIDENT_BYTES", str(1024 * 16))
    _, k2, c2 = counter.count_reads_to_host([str(fq)], k, chunk_len=1024,
                                            tlog=logs.append)
    assert any("ladder eviction" in l for l in logs), logs
    assert np.array_equal(k1, k2)
    assert np.array_equal(c1, c2)
