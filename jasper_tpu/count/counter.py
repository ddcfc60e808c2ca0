"""Canonical k-mer counting of reads into the device table.

Device equivalent of `jellyfish count -C` (reference
sub_commands/count_main.cc:218-385). Where jellyfish amortizes random-access
latency with N pthreads CAS-inserting into a shared hash
(hash_counter.hpp:91-126), this counter amortizes with a sort: fixed-size
code chunks stream to the device, every window is extracted/canonicalized in
vectorized form, each chunk collapses to a sorted run of (distinct key,
count) by sort + segment-sum, runs accumulate in an LSM-style level list
(jasper_tpu.count.sorted_runs), and ONE waterfall build materializes the
bucketed lookup table at the end (jasper_tpu.table.build). No scatter in the
steady state. Whether sort beats a scatter/atomics insert on the H100 is
not measured yet (tools/layout_sweep.py measures the primitives).

Sizing: the reference's cooperative size-doubling (hash_counter.hpp:178-238)
has no analog because runs grow fluidly; the jellyfish `-s` hint (reads
bytes / 10, reference src/jasper.sh:82) only seeds the --disk dump
threshold and the final table's size estimate.
"""

from __future__ import annotations

from typing import Iterable

import jax.numpy as jnp
import numpy as np

from jasper_tpu.count.sorted_runs import (
    RunAccumulator,
    extract_windows,
    run_from_keys,
)
from jasper_tpu.io.fastx import stream_codes, total_file_bytes
from jasper_tpu.ops.kmer import canonical_windows
from jasper_tpu.table.build import build_table
from jasper_tpu.table.kmer_table import empty_table, slots_for

GROW_LOAD_LIMIT = 0.8  # sizing headroom for the --disk dump threshold


def _unique_chunk_keys(codes: np.ndarray, k: int, canonical: bool):
    """Host-side: unique (keys, multiplicities) of one code chunk."""
    from jasper_tpu.ops.kmer import forward_windows

    extract = canonical_windows if canonical else forward_windows
    keys, valid = extract(np, codes, k)
    keys = keys[valid]
    if len(keys) == 0:
        return keys, np.zeros(0, np.uint32)
    W = keys.shape[1]
    order = np.lexsort([keys[:, j] for j in range(W)])
    keys = keys[order]
    new_seg = np.ones(len(keys), dtype=bool)
    new_seg[1:] = (keys[1:] != keys[:-1]).any(axis=1)
    starts = np.flatnonzero(new_seg)
    mult = np.diff(np.append(starts, len(keys))).astype(np.uint32)
    return keys[starts], mult


def _prefetch(it, depth: int = 3):
    """Run an iterator on a background thread, `depth` items ahead.

    Host FASTQ parsing and device counting otherwise strictly alternate
    (each chunk parses, then dispatches, then the next parse starts); with
    the parser ahead on its own thread the device never waits on ingest.
    stream_codes allocates a fresh buffer per yielded chunk, so queued
    chunks are never mutated. Exceptions re-raise at the consumer."""
    import queue
    import threading

    q: queue.Queue = queue.Queue(maxsize=depth)
    DONE = object()

    class _Raised:
        def __init__(self, exc):
            self.exc = exc

    def worker():
        try:
            for item in it:
                q.put(item)
            q.put(DONE)
        except BaseException as e:  # noqa: BLE001 - propagated to consumer
            q.put(_Raised(e))

    t = threading.Thread(target=worker, name="ingest-prefetch", daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is DONE:
            break
        if isinstance(item, _Raised):
            raise item.exc
        yield item


def count_reads(
    paths: Iterable[str],
    k: int,
    n_slots: int | None = None,
    chunk_len: int = 1 << 23,  # chosen on an earlier device; untuned on the H100
    hash_size_hint: int | None = None,
    progress=None,
    canonical: bool = True,
    min_qual_char: str | None = None,
    key_filter=None,
    on_full=None,
    mesh=None,
    return_run: bool = False,
    return_acc: bool = False,
    on_full_run=None,
    partition=None,
    codes_sink=None,
    codes_source=None,
    accumulator=None,
):
    """Count k-mers of all reads in `paths`; returns the table.

    key_filter: optional (unique_keys uint32 [U, W], mults uint32 [U]) ->
    adjusted mults — the prefilter hook behind `--bc`, `--bf-*` and `--if`
    (reference count_main.cc:109-131 filter classes). When set, window
    extraction and dedup run host-side and only the filtered insert runs on
    device.

    on_full: optional callback(tab) -> None. When set, accumulated runs are
    NOT kept past ~n_slots resident lanes; instead the callback receives a
    built table (to dump to disk) and counting resumes empty — the
    reference's --disk dump-and-merge mode (count_main.cc:187-192,347-373).
    The caller dumps/merges the returned final table itself.

    mesh: optional 1-axis ("data",) jax Mesh — chunks deal round-robin to
    its devices, each running its own sorted-run ladder; the final table
    byte-matches the single-device stream (count/mesh_runs.py). The
    key_filter path (host-driven) ignores the mesh.

    return_run=True additionally returns the final compacted run
    (h, keys, counts, n_active device arrays, sorted by (mix32, key),
    actives first) so callers can pull the ~12 B/record distinct set
    instead of the ~40 B/record built table. Returns (tab, run); run is
    None for empty inputs.
    """
    paths = list(paths)
    total_bytes = total_file_bytes(paths)
    if n_slots is None:
        if hash_size_hint is None:
            hash_size_hint = max(1024, total_bytes // 10)
        n_slots = slots_for(max(hash_size_hint, chunk_len), GROW_LOAD_LIMIT)
    # clamp the chunk to the input size (next power of two; .gz estimated at
    # 4x) so small runs don't pad tiny inputs to the full 8M-lane programs
    est = total_bytes * (4 if any(
        isinstance(p, str) and p.endswith(".gz") for p in paths) else 1)
    if est > 0:
        cap = 1 << max(14, (max(est, 4 * k) - 1).bit_length())
        chunk_len = min(chunk_len, cap)
    n_windows = chunk_len - k + 1
    if mesh is not None and key_filter is None and mesh.shape["data"] > 1:
        return _count_reads_mesh(
            paths, k, chunk_len, mesh, canonical, min_qual_char, progress,
            on_full, n_slots, return_run, return_acc, on_full_run,
            partition, codes_sink, codes_source,
        )
    acc = accumulator if accumulator is not None else RunAccumulator(
        unit=max(1 << 14, n_windows // 8), stage_lanes=8 * n_windows)
    occupied = 0
    n_chunks = 0
    chunk_iter = (iter(codes_source) if codes_source is not None
                  else _prefetch(stream_codes(paths, k, chunk_len, min_qual_char)))
    for codes, _fill in chunk_iter:
        if codes_sink is not None:
            codes_sink.append((codes, _fill))
        if on_full is not None and acc.n_resident_lanes() > n_slots:
            on_full(_finish_to_table(acc, k))
            acc = RunAccumulator(unit=acc.unit)
        if on_full_run is not None and acc.n_settled_lanes() > n_slots:
            # eager eviction: the caller pulls the resident levels to host
            # and counting resumes into a fresh ladder (device memory stays
            # bounded regardless of total distinct keys). An injected
            # accumulator (single-pass partitioned counting) evicts inside
            # the callback and stays in place.
            on_full_run(acc)
            if accumulator is None:
                acc = RunAccumulator(unit=acc.unit, stage_lanes=acc.stage_lanes)
        if key_filter is None:
            keys, valid = extract_windows(jnp.asarray(codes), k, canonical,
                                          partition=partition)
            acc.push_raw(keys, valid)
        else:
            ukeys, mult = _unique_chunk_keys(codes, k, canonical)
            mult = np.asarray(key_filter(ukeys, mult), dtype=np.uint32)
            keep = mult > 0
            h, keys, counts, n_act = run_from_keys(ukeys[keep], mult[keep], k)
            acc.push(h, keys, counts, int(n_act))
        occupied = acc.n_resident_lanes()
        n_chunks += 1
        if progress is not None:
            progress(n_chunks, occupied)
    if return_acc:
        return acc
    return _finish_to_table(acc, k, return_run)


def _count_reads_mesh(paths, k, chunk_len, mesh, canonical, min_qual_char,
                      progress, on_full, n_slots, return_run=False,
                      return_acc=False, on_full_run=None, partition=None,
                      codes_sink=None, codes_source=None):
    """Data-parallel counting over the mesh's "data" devices: groups of D
    chunks extract + sort device-local; final fold builds one table
    (count/mesh_runs.py). Byte-identical to the single-device stream."""
    import jax

    from jasper_tpu.count.mesh_runs import MeshRunAccumulator

    D = mesh.shape["data"]
    n_windows = chunk_len - k + 1
    acc = MeshRunAccumulator(mesh, unit=max(1 << 14, n_windows // 8),
                             stage_lanes=8 * n_windows)
    vextract = jax.vmap(
        lambda c: extract_windows(c, k, canonical, partition=partition))
    group: list[np.ndarray] = []
    n_chunks = 0

    def _push_group():
        nonlocal group
        batch = np.full((D, chunk_len), 4, dtype=np.uint8)  # CODE_N pad
        for i, c in enumerate(group):
            batch[i, : len(c)] = c
        group = []
        keys, valid = vextract(jax.device_put(batch, acc.sharding))
        acc.push_raw(keys, valid)

    chunk_iter = (iter(codes_source) if codes_source is not None
                  else _prefetch(stream_codes(paths, k, chunk_len, min_qual_char)))
    for codes, _fill in chunk_iter:
        if codes_sink is not None:
            codes_sink.append((codes, _fill))
        if on_full is not None and acc.n_resident_lanes() > n_slots:
            if group:
                _push_group()
            on_full(_finish_to_table(acc, k))
            acc = MeshRunAccumulator(mesh, unit=acc.unit,
                                     stage_lanes=acc.stage_lanes)
        if on_full_run is not None and acc.n_settled_lanes() > n_slots:
            if group:
                _push_group()
            on_full_run(acc)
            acc = MeshRunAccumulator(mesh, unit=acc.unit,
                                     stage_lanes=acc.stage_lanes)
        group.append(codes)
        n_chunks += 1
        if len(group) == D:
            _push_group()
        if progress is not None:
            progress(n_chunks, acc.n_resident_lanes())
    if group:
        _push_group()
    if return_acc:
        return acc
    return _finish_to_table(acc, k, return_run)


def _finish_to_table(acc, k: int, return_run: bool = False):
    run = acc.finish()
    if run is None:
        tab = empty_table(k, 64)
        return (tab, None) if return_run else tab
    tab = build_table(run, k)
    return (tab, run) if return_run else tab


def pull_run_records(run, slice_lanes: int = 1 << 23, consumer=None):
    """Device run -> host (keys uint32 [N, W], counts uint32 [N]).

    Moves the minimum bytes over the device->host link: keys at 4W B/record
    and counts as uint8 with a tiny escape list for counts >= 255 (at
    coverage-scale inputs >99% of distinct k-mers are error singletons or
    near the mean coverage). Record order is the run order — sorted by
    (mix32(key), key), actives first — the exact precondition of
    HostKmerTable.from_sorted_run.

    The pull streams in slice_lanes slices with the NEXT slice's
    device->host copy in flight while the previous one lands, and calls
    ``consumer(keys_slice, counts_slice, h_slice)`` per slice so host-side
    work (waterfall placement) overlaps the transfer. When the native
    library is present, h is NOT pulled: mix32 recomputes from the landed
    keys on the host (jt_mix32_batch), saving 4 B/record of d2h (~30% of
    the pull).
    """
    from jasper_tpu.io import native_jf

    pull_h = not native_jf.available()
    h, keys, counts, n_active = run
    n = int(n_active)
    W = keys.shape[1]
    if n == 0:
        return np.zeros((0, W), np.uint32), np.zeros(0, np.uint32)
    c8_dev = jnp.minimum(counts[:n], 255).astype(jnp.uint8)
    # escapes first (counts >= 255, rare): their exact values patch each
    # landed slice BEFORE the consumer sees it
    n_esc = int(jnp.sum((counts[:n] >= jnp.uint32(255)).astype(jnp.uint32)))
    esc_idx = np.zeros(0, np.int64)
    esc_val = np.zeros(0, np.uint32)
    if n_esc:
        cap = 1 << (int(n_esc) - 1).bit_length()
        idx = jnp.nonzero(counts[:n] >= jnp.uint32(255), size=cap,
                          fill_value=n)[0]
        vals = jnp.where(idx < n, counts[jnp.minimum(idx, n - 1)], 0)
        idx_np = np.asarray(idx).astype(np.int64)
        m = idx_np < n
        esc_idx, esc_val = idx_np[m], np.asarray(vals)[m]

    starts = list(range(0, n, slice_lanes))
    pairs = []

    def _slice(s):
        e = min(s + slice_lanes, n)
        tup = (keys[s:e], c8_dev[s:e], h[s:e] if pull_h else None)
        for a in tup:
            if a is not None:
                a.copy_to_host_async()
        return tup

    for s in starts[:2]:
        pairs.append(_slice(s))
    keys_np = np.empty((n, W), np.uint32)
    counts_np = np.empty(n, np.uint32)
    for i, s in enumerate(starts):
        if i + 2 < len(starts):
            pairs.append(_slice(starts[i + 2]))
        kd, cd, hd = pairs[i]
        e = min(s + slice_lanes, n)
        keys_np[s:e] = np.asarray(kd)
        counts_np[s:e] = np.asarray(cd)
        h_np = (np.asarray(hd) if pull_h
                else native_jf.mix32_batch(keys_np[s:e]))
        pairs[i] = None  # free device refs
        lo = np.searchsorted(esc_idx, s)
        hi = np.searchsorted(esc_idx, e)
        counts_np[esc_idx[lo:hi]] = esc_val[lo:hi]
        if consumer is not None:
            consumer(keys_np[s:e], counts_np[s:e], h_np)
    return keys_np, counts_np


def count_sequences(seqs: Iterable[str], k: int, n_slots: int = 1 << 16):
    """Count k-mers of in-memory sequences (testing convenience)."""
    from jasper_tpu.ops.codes import CODE_N, encode

    parts = []
    for s in seqs:
        parts.append(encode(s))
        parts.append(np.array([CODE_N], dtype=np.uint8))
    codes = np.concatenate(parts) if parts else np.zeros(0, dtype=np.uint8)
    if len(codes) < k:
        return empty_table(k, n_slots)
    from jasper_tpu.count.sorted_runs import chunk_to_run

    run = chunk_to_run(jnp.asarray(codes), k)
    return build_table((run[0], run[1], run[2], int(run[3])), k)


# -- chromosome-scale finish: per-level pulls + native host k-way merge -------

# Device budgets (jasper_tpu.utils.budgets, shares of the device memory
# limit): scale_finish_lanes() bounds the resident lanes the device
# merge-all finish takes on (concat + sort of the whole record set is ~2x
# records transient, plus the final run; beyond it, levels pull and merge
# on the host); partition_resident_bytes() bounds a grouped partitioned
# pass's ladders before they all evict to the host (they share the device
# with staging buffers, flush-sort transients, pending merge queues and
# the previous pass's pulls in flight).
import os as _os

from jasper_tpu.utils.budgets import (
    dev_build_bytes,
    partition_resident_bytes,
    scale_finish_lanes as _scale_finish_lanes,
)


_ESC_CAP = 65536  # fixed async escape-list capacity (counts >= 65535 keys)


def start_level_pull(h, keys, counts, slice_lanes: int = 1 << 23,
                     pull_h: bool | None = None):
    """Issue ALL async d2h copies for one level run WITHOUT any host sync;
    returns a thunk whose call materializes (h, keys, counts) trimmed to
    actives.

    Built for overlap: the transfers proceed while the caller keeps
    dispatching device work (counting continues during an eviction), and
    the thunk only blocks on whatever hasn't landed yet. Counts travel as
    uint16 with a FIXED-capacity escape list for >= 65535 (a handful of
    ultra-high-frequency k-mers per genome; sizing it statically avoids the
    n_esc host sync the u8-escape scheme needs). h is recomputed on the
    host via the native mix32 kernel instead of pulled (-4 B/record of d2h)
    unless the native library is missing (pull_h=None auto-detects)."""
    from jasper_tpu.io import native_jf

    if pull_h is None:
        pull_h = not native_jf.available()
    L = h.shape[0]
    W = keys.shape[1]
    if L == 0:
        def _empty():
            return (np.zeros(0, np.uint32), np.zeros((0, W), np.uint32),
                    np.zeros(0, np.uint32))
        _empty.ready = lambda: True
        return _empty
    c16 = jnp.minimum(counts, 65535).astype(jnp.uint16)
    big = counts >= jnp.uint32(65535)
    esc_idx_dev = jnp.nonzero(big, size=_ESC_CAP, fill_value=L)[0]
    esc_val_dev = jnp.where(esc_idx_dev < L,
                            counts[jnp.minimum(esc_idx_dev, L - 1)], 0)
    slices = []
    for s in range(0, L, slice_lanes):
        e = min(s + slice_lanes, L)
        tup = ((h[s:e] if pull_h else None), keys[s:e], c16[s:e])
        for a in tup:
            if a is not None:
                a.copy_to_host_async()
        slices.append((s, e, tup))
    for a in (esc_idx_dev, esc_val_dev):
        a.copy_to_host_async()

    def ready() -> bool:
        """True when every async copy has landed (materialize won't block)."""
        if not slices:
            return True
        try:
            for _, _, tup in slices:
                for a in tup:
                    if a is not None and not a.is_ready():
                        return False
            return True
        except AttributeError:
            return True

    def materialize():
        h_np = np.empty(L, np.uint32) if pull_h else None
        keys_np = np.empty((L, W), np.uint32)
        counts_np = np.empty(L, np.uint32)
        for s, e, (hd, kd, cd) in slices:
            if pull_h:
                h_np[s:e] = np.asarray(hd)
            keys_np[s:e] = np.asarray(kd)
            counts_np[s:e] = np.asarray(cd)
        slices.clear()  # free device refs
        idx_np = np.asarray(esc_idx_dev).astype(np.int64)
        m = idx_np < L
        if m.all():
            # escape capacity overflow (pathological): exact blocking re-pull
            counts_np = np.asarray(counts)
        else:
            counts_np[idx_np[m]] = np.asarray(esc_val_dev)[m]
        dead = np.nonzero(counts_np == 0)[0]
        n_act = int(dead[0]) if len(dead) else L
        if pull_h:
            return h_np[:n_act], keys_np[:n_act], counts_np[:n_act]
        hh = native_jf.mix32_batch(keys_np[:n_act])
        return hh, keys_np[:n_act], counts_np[:n_act]

    materialize.ready = ready
    return materialize


def pull_level_records(h, keys, counts, slice_lanes: int = 1 << 23):
    """One resident level run -> host (h, keys, counts) trimmed to actives
    (blocking convenience over start_level_pull)."""
    return start_level_pull(h, keys, counts, slice_lanes)()


def start_all_level_pulls(acc, slice_lanes: int = 1 << 23):
    """Flush + drain the accumulator and ISSUE async pulls for every
    resident level (mesh accumulators contribute one pull per device row);
    returns the materialization thunks. The transfers ride the d2h link
    while the caller keeps counting — eviction overlap."""
    acc.flush_stage()
    acc._drain(block=True)
    thunks = []
    for j in sorted(acc.levels):
        h, keys, counts = acc.levels.pop(j)
        rows = [(h, keys, counts)] if h.ndim == 1 else [
            (jnp.asarray(h[d]), jnp.asarray(keys[d]), jnp.asarray(counts[d]))
            for d in range(h.shape[0])
        ]
        del h, keys, counts
        for hr, kr, cr in rows:
            thunks.append(start_level_pull(hr, kr, cr, slice_lanes))
    return thunks


def pull_all_levels(acc, slice_lanes: int = 1 << 23):
    """Blocking form of start_all_level_pulls: list of non-empty
    (h, keys, counts) streams."""
    streams = [t() for t in start_all_level_pulls(acc, slice_lanes)]
    return [s for s in streams if len(s[0])]


def finish_runs_to_host(acc, slice_lanes: int = 1 << 23, extra_streams=()):
    """Pull every resident LSM level and k-way merge on the HOST (plus any
    previously evicted streams).

    The device merge-all finish doubles peak memory (concat + sort of the
    full record set); at chromosome scale (~280 M distinct at 100 Mbp @40x)
    that transient can exceed the device budget. Per-level pulls bound device memory
    at the largest single level, and the native heap merge
    (jt_merge_runs_multi — the host analog of jellyfish merge_files,
    jf:jellyfish/merge_files.cc:45-101) restores the single distinct stream
    in (mix32, key) order. Returns (h, keys, counts) host arrays, or None
    for an empty accumulator."""
    from jasper_tpu.io import native_jf

    streams = list(extra_streams) + pull_all_levels(acc, slice_lanes)
    if not streams:
        return None
    return merge_host_streams(streams)


def merge_host_streams(streams):
    """Merge sorted distinct-key streams on the host (native k-way heap,
    numpy radix fallback). streams: [(h, keys, counts)] each (h, key)
    ascending with distinct keys within a stream; counts sum (saturating).
    """
    from jasper_tpu.io import native_jf

    merged = native_jf.merge_runs_multi(streams)
    if merged is None:
        # numpy fallback: concat + radix argsort + segment-sum
        hs = np.concatenate([s[0] for s in streams])
        ks = np.concatenate([s[1] for s in streams], axis=0)
        cs = np.concatenate([s[2] for s in streams]).astype(np.uint64)
        W = ks.shape[1]
        from jasper_tpu.io.jf import _radix_lexsort

        order = _radix_lexsort([ks[:, j] for j in range(W)] + [hs])
        hs, ks, cs = hs[order], ks[order], cs[order]
        new = np.ones(len(hs), bool)
        new[1:] = (hs[1:] != hs[:-1]) | (ks[1:] != ks[:-1]).any(axis=1)
        seg = np.cumsum(new) - 1
        sums = np.zeros(int(seg[-1]) + 1, np.uint64)
        np.add.at(sums, seg, cs)
        sums = np.minimum(sums, 0xFFFFFFFF).astype(np.uint32)
        merged = (hs[new], ks[new], sums)
    return merged


def count_reads_to_host(
    paths: Iterable[str],
    k: int,
    hash_size_hint: int | None = None,
    mesh=None,
    chunk_len: int = 1 << 23,
    slice_lanes: int = 1 << 23,
    canonical: bool = True,
    min_qual_char: str | None = None,
    progress=None,
    tlog=None,
    scale_finish_lanes: int | None = None,
    return_device_table: bool = False,
):
    """Driver counting entry: count reads and land the distinct set on the
    HOST — (host_table, keys uint32 [N, W], counts uint32 [N]) in
    (mix32, key) order; with return_device_table=True a 4th element is the
    DEVICE-built lookup table when the classic finish ran (the run was
    already on device, so building there saves re-pushing the multi-GB
    table over h2d at polish start) or None otherwise.

    Finish strategy by resident size: small sets merge-all on device and
    stream the single run's pull through the incremental waterfall builder
    (transfer-overlapped); sets past the device finish budget
    (SCALE_FINISH_LANES) pull per-level and merge on the host
    (finish_runs_to_host), bounding device memory at the largest level.
    Sets that outgrow even that DURING counting (chr1-scale) evict their
    resident levels to the host mid-stream (on_full_run at 2x the budget)
    so device memory stays bounded regardless of total distinct keys."""
    from jasper_tpu.table.host_table import HostKmerTable, TableOverflow

    def _log(msg):
        if tlog is not None:
            tlog(msg)

    budget = (_scale_finish_lanes() if scale_finish_lanes is None
              else scale_finish_lanes)

    # hash-partitioned multi-pass counting: when the distinct-set ESTIMATE
    # (jellyfish's own -s heuristic, reads bytes/10) far exceeds the device
    # finish budget and the inputs are re-readable files, count in P passes
    # over the SAME reads, pass p keeping only windows whose mix32 top bits
    # select partition p. Per-pass distinct sets are budget-sized (classic
    # device LSM per pass), partitions are disjoint so nothing is pulled
    # twice, and pass p's async pulls overlap pass p+1's counting. Codes
    # chunks are parsed once and cached in RAM (JT_CODES_CACHE_BYTES cap)
    # so re-passes skip the FASTQ parse. The reference analog is
    # jellyfish's bounded-memory --disk dump-and-merge
    # (count_main.cc:187-192,347-373) — same capability, no disk.
    est = hash_size_hint if hash_size_hint else 0
    P = 1
    env_p = _os.environ.get("JT_COUNT_PARTITIONS")
    if env_p:
        P = max(1, int(env_p))
    else:
        # per-pass distinct must leave device headroom for the ladder's
        # merge transients and the async pending queue
        while est // P > budget and P < 16:
            P *= 2
    seekable = all(isinstance(q, str) for q in paths)
    if P > 1 and mesh is None:
        from jasper_tpu.count.sorted_runs import PartitionSliceOverflow
        from jasper_tpu.ops.kmer import words_per_kmer

        # group count: passes G chosen so one pass's resident ladders fit
        # the device budget WITHOUT evictions. The -s estimate (reads
        # bytes/10) overcounts distinct ~3x on coverage data (race100:
        # est 822M vs 278.4M actual); mid-count LSM levels hold ~2x the
        # final distinct in lanes (duplicate keys across unmerged levels —
        # the practice leg's pass 1 evicted at a 1.4x padding assumption).
        # When the discount is wrong the eviction valve catches it.
        lane_bytes = 4 * (words_per_kmer(k) + 2)
        est_lanes = est // 3 * 2
        G = 1
        env_g = _os.environ.get("JT_COUNT_GROUPS")
        if env_g:
            G = max(1, int(env_g))
        else:
            resident_bytes = partition_resident_bytes()
            while (G < P
                   and est_lanes * lane_bytes // G > resident_bytes):
                G *= 2
        if G > 1 and not seekable:
            G = 1  # non-seekable inputs get one pass + the eviction valve
        try:
            return _count_partitioned_single_pass(
                paths, k, P, G, chunk_len, slice_lanes, canonical,
                min_qual_char, progress, _log, return_device_table)
        except PartitionSliceOverflow:
            # adversarial hash skew (never under an honest mix32): redo
            # with the capacity-free P-pass extraction filter
            if not seekable:
                raise
            _log("count: partition slice overflow — redoing with the "
                 "P-pass filter")
    if P > 1 and seekable:
        return _count_partitioned(
            paths, k, P, mesh, chunk_len, slice_lanes, canonical,
            min_qual_char, progress, _log, return_device_table)

    evicted: list = []
    pending_pulls: list = []

    def _materialize_pending():
        for t in pending_pulls:
            s = t()
            if len(s[0]):
                evicted.append(s)
        pending_pulls.clear()

    def _evict(acc_):
        # previous eviction's transfers had the whole intervening counting
        # interval to land; materialize them, then issue this eviction's
        # async pulls and return immediately — counting resumes while the
        # new transfers ride the d2h link
        _materialize_pending()
        pending_pulls.extend(start_all_level_pulls(acc_, slice_lanes))
        _log(f"count: eviction started ({len(pending_pulls)} level runs in "
             f"flight, {sum(len(s[0]) for s in evicted)} records landed)")

    acc = count_reads(paths, k, hash_size_hint=hash_size_hint, mesh=mesh,
                      chunk_len=chunk_len, canonical=canonical,
                      min_qual_char=min_qual_char, progress=progress,
                      n_slots=max(2 * budget, 1024), on_full_run=_evict,
                      return_acc=True)
    resident = acc.n_resident_lanes()
    _log(f"count: device counting done ({resident} resident lanes)")
    _materialize_pending()
    if evicted or resident > budget:
        from jasper_tpu.io import native_jf  # noqa: F401 (fallback inside)

        merged = finish_runs_to_host(acc, slice_lanes, extra_streams=evicted)
        if merged is None:
            host_table = HostKmerTable.empty(k, 64)
            return (host_table, np.zeros((0, host_table.W), np.uint32),
                    np.zeros(0, np.uint32))
        rh, rkeys, rcounts = merged
        _log(f"count: host-merge finish done ({len(rkeys)} records)")
        host_table = HostKmerTable.from_sorted_run(k, rkeys, rcounts, h=rh)
        _log("count: host table built")
        dev_tab = None
        if return_device_table:
            dev_tab = _device_table_from_host_run(rh, rkeys, rcounts, k)
            if dev_tab is not None:
                _log("count: device scan table built (from merged run)")
        out = (host_table, rkeys, rcounts)
        return out + (dev_tab,) if return_device_table else out

    run = acc.finish()
    if run is None:
        host_table = HostKmerTable.empty(k, 64)
        out = (host_table, np.zeros((0, host_table.W), np.uint32),
               np.zeros(0, np.uint32))
        return out + (None,) if return_device_table else out
    dev_tab = None
    if return_device_table and _device_table_fits(int(run[3]), k):
        # the run is on device anyway: build the polish-scan lookup table
        # there (~1 s) instead of pushing the multi-GB host table back over
        # h2d at scanner construction
        dev_tab = build_table(run, k)
        _log("count: device scan table built")
    n_rec = int(run[3])
    builder = HostKmerTable.builder(k, n_rec)

    def _consume(ks, cs, hs):
        nonlocal builder
        if builder is not None:
            try:
                builder.push(ks, cs, hs)
            except TableOverflow:
                builder = None  # rebuild below from the full arrays

    rkeys, rcounts = pull_run_records(run, slice_lanes, consumer=_consume)
    _log(f"count: run pull done ({n_rec} records)")
    host_table = (builder.finish() if builder is not None
                  else HostKmerTable.from_sorted_run(k, rkeys, rcounts))
    _log("count: host table built")
    out = (host_table, rkeys, rcounts)
    return out + (dev_tab,) if return_device_table else out


def _count_partitioned(paths, k, P, mesh, chunk_len, slice_lanes, canonical,
                       min_qual_char, progress, _log,
                       return_device_table=False):
    """P-pass hash-partitioned counting (see count_reads_to_host)."""
    from jasper_tpu.io.fastx import total_file_bytes as _tfb
    from jasper_tpu.table.host_table import HostKmerTable

    cache_cap = int(_os.environ.get("JT_CODES_CACHE_BYTES", str(16 << 30)))
    use_cache = _tfb(list(paths)) <= cache_cap
    codes_cache: list | None = [] if use_cache else None
    parts: list = []
    pending: list = []

    def _materialize_prev():
        if not pending:
            return
        streams = [t() for t in pending.pop()]
        streams = [s for s in streams if len(s[0])]
        if streams:
            parts.append(merge_host_streams(streams))

    # safety valve: if a pass's ladder still outgrows the device budget
    # (the distinct estimate lied), evict its levels mid-pass; the per-pass
    # merge accepts any number of streams
    valve_streams: list = []

    def _valve(acc_):
        valve_streams.extend(
            s for s in (t() for t in start_all_level_pulls(acc_, slice_lanes))
            if len(s[0]))
        _log(f"count: partition-pass eviction ({len(valve_streams)} streams)")

    for p_idx in range(P):
        sink = codes_cache if (use_cache and p_idx == 0) else None
        source = codes_cache if (use_cache and p_idx > 0) else None
        acc = count_reads(
            paths, k, mesh=mesh, chunk_len=chunk_len, canonical=canonical,
            min_qual_char=min_qual_char, progress=progress,
            partition=(p_idx, P), return_acc=True,
            codes_sink=sink, codes_source=source,
            n_slots=_scale_finish_lanes(), on_full_run=_valve,
        )
        _materialize_prev()  # previous pass's transfers have landed by now
        pending.append(start_all_level_pulls(acc, slice_lanes))
        if valve_streams:
            pending[-1] = list(pending[-1])  # thunks list
            vs, valve_streams = valve_streams, []
            pending[-1].extend((lambda s=s: s) for s in vs)
        _log(f"count: partition pass {p_idx + 1}/{P} counted, pull in flight")
    _materialize_prev()
    return _host_finish_from_parts(parts, k, _log, return_device_table)


def _host_finish_from_parts(parts, k, _log, return_device_table):
    """Concatenate per-partition host streams (already in global (h, key)
    order: partition = top hash bits) into the standard counting result
    (host_table, rkeys, rcounts[, dev_tab])."""
    from jasper_tpu.table.host_table import HostKmerTable

    if not parts:
        host_table = HostKmerTable.empty(k, 64)
        out = (host_table, np.zeros((0, host_table.W), np.uint32),
               np.zeros(0, np.uint32))
        return out + (None,) if return_device_table else out
    rh = np.concatenate([pp[0] for pp in parts])
    rkeys = np.concatenate([pp[1] for pp in parts], axis=0)
    rcounts = np.concatenate([pp[2] for pp in parts])
    del parts
    _log(f"count: partitioned finish done ({len(rkeys)} records)")
    host_table = HostKmerTable.from_sorted_run(k, rkeys, rcounts, h=rh)
    _log("count: host table built")
    dev_tab = None
    if return_device_table:
        dev_tab = _device_table_from_host_run(rh, rkeys, rcounts, k)
        if dev_tab is not None:
            _log("count: device scan table built (from merged run)")
    out = (host_table, rkeys, rcounts)
    return out + (dev_tab,) if return_device_table else out


def _count_partitioned_single_pass(paths, k, P, G, chunk_len, slice_lanes,
                                   canonical, min_qual_char, progress, _log,
                                   return_device_table):
    """Grouped partitioned counting: G passes over the reads, pass g holding
    the 1/G hash subrange [g/G, (g+1)/G) resident as P/G per-partition LSM
    ladders (sorted_runs.PartitionedRunAccumulator). Within a pass, every
    window is extracted and stage-sorted exactly ONCE and the compacted
    distinct stream splits into per-partition slices on device — so the
    P-pass extraction filter's P-fold re-extraction (r4) shrinks to G-fold,
    with G chosen so a pass's residents fit the device budget WITHOUT
    evictions (each record then crosses the d2h link exactly once; the
    fully-single-pass variant measured 4 eviction epochs of duplicate pulls
    at 100 Mbp and lost to the link). G == 1 degenerates to one pass with
    all partitions resident; G == P to the old multi-pass. The eviction
    valve stays as the safety net when the estimate lies low.
    """
    from jasper_tpu.count.sorted_runs import PartitionedRunAccumulator

    assert P % G == 0
    PL = P // G  # resident ladders per pass
    bits_total = max(P.bit_length() - 1, 0)
    n_windows = chunk_len - k + 1
    part_streams: dict[int, list] = {p: [] for p in range(P)}
    pending_pulls: list = []  # (global_p, thunk): transfers in flight

    def _materialize_pending():
        for p, t in pending_pulls:
            s = t()
            if len(s[0]):
                part_streams[p].append(s)
        pending_pulls.clear()

    def _materialize_landed():
        """Non-blocking: land finished pulls so their DEVICE buffers free
        while the next pass counts (a pass's final runs otherwise stay
        resident until the next blocking materialize — at G=2 that is ~3 GB
        riding on top of the next pass's residents)."""
        done = [i for i, (_, t) in enumerate(pending_pulls)
                if getattr(t, "ready", lambda: False)()]
        for i in reversed(done):
            p, t = pending_pulls.pop(i)
            s = t()
            if len(s[0]):
                part_streams[p].append(s)

    for g in range(G):
        p0 = g * PL
        # smaller staging than the single-ladder path (4x vs 8x chunk
        # windows): ladders ride alongside the flush-sort transients
        pacc = PartitionedRunAccumulator(
            PL, unit=max(1 << 14, n_windows // 8),
            stage_lanes=4 * n_windows, p0=p0, bits_total=bits_total)

        def _evict(_acc, pacc=pacc, p0=p0):
            # safety valve (estimate lied low): ALL resident ladders flush
            # to the host at once — evicting only the largest regains ~1/PL
            # of the budget and re-triggers every stage while evicted keys
            # re-accumulate, drowning the d2h link in duplicate pulls (the
            # r4 eviction trap, measured again on the 100 Mbp practice leg)
            _materialize_pending()
            for pl in range(pacc.P):
                pending_pulls.extend(
                    (p0 + pl, t)
                    for t in start_all_level_pulls(pacc.accs[pl], slice_lanes))
            _log(f"count: pass {g + 1}/{G} ladder eviction "
                 f"({len(pending_pulls)} level runs in flight)")

        from jasper_tpu.ops.kmer import words_per_kmer

        lane_bytes = 4 * (words_per_kmer(k) + 2)  # h + key words + count

        def _tick(n_chunks, occupied, _user=progress):
            _materialize_landed()
            if _user is not None:
                _user(n_chunks, occupied)

        count_reads(paths, k, chunk_len=chunk_len, canonical=canonical,
                    min_qual_char=min_qual_char, progress=_tick,
                    return_acc=True, accumulator=pacc,
                    partition=(g, G) if G > 1 else None,
                    n_slots=partition_resident_bytes() // lane_bytes,
                    on_full_run=_evict)
        pacc.drain()
        _log(f"count: pass {g + 1}/{G} counted "
             f"({pacc.n_resident_lanes()} resident lanes, {PL} ladders)")
        # previous transfers have had the whole pass to land
        _materialize_pending()
        # finish ladders in partition order; pulls ride the link while the
        # next ladder's device merge-all (and the next pass's count) run
        for pl in range(PL):
            run = pacc.accs[pl].finish()
            if run is not None:
                h, keys, counts, n = run
                if n:
                    pending_pulls.append(
                        (p0 + pl, start_level_pull(h[:n], keys[:n],
                                                   counts[:n], slice_lanes)))
        del pacc
    _materialize_pending()

    parts = []
    for p in range(P):
        ss = part_streams[p]
        if not ss:
            continue
        parts.append(ss[0] if len(ss) == 1 else merge_host_streams(ss))
    return _host_finish_from_parts(parts, k, _log, return_device_table)


def _device_table_from_host_run(rh, rkeys, rcounts, k):
    """Push the compact merged run (16 B/record) and build the scan table
    ON DEVICE — ~2.4x fewer h2d bytes than pushing the built table
    (table/build.py). Returns None when the table exceeds the device build
    kernel's int32 flat addressing (~2^31 u32 = 8 GB; chromosome-scale
    sets) or the device build budget — the scanner then pushes the
    host-built table instead."""
    from jasper_tpu.ops.kmer import words_per_kmer
    from jasper_tpu.table.kmer_table import PAD_BUCKETS, ROW_U32,         slot_words_for, slots_for

    from jasper_tpu.table.kmer_table import adaptive_load

    sw = slot_words_for(words_per_kmer(k))
    n_slots = slots_for(max(len(rh), 1), adaptive_load(len(rh), k))
    n_buckets = max(1, -(-n_slots // (ROW_U32 // sw)))
    if (n_buckets + PAD_BUCKETS) * ROW_U32 >= (1 << 31):
        return None
    run_bytes = 4 * (2 + rkeys.shape[1]) * len(rh)
    tab_bytes = (n_buckets + PAD_BUCKETS) * ROW_U32 * 4
    if run_bytes + tab_bytes > dev_build_bytes():
        # pushing the records AND holding the table must fit the device
        # build budget; past it the scanner's sliced donated table push
        # carries the table instead
        return None
    run = (jnp.asarray(rh), jnp.asarray(rkeys), jnp.asarray(rcounts),
           len(rh))
    return build_table(run, k)


def _device_table_fits(n_records: int, k: int) -> bool:
    """True when the device build kernel can flat-address the table
    (table/build.py asserts total u32 < 2^31; beyond that the scanner
    pushes the host-built table over h2d instead)."""
    from jasper_tpu.ops.kmer import words_per_kmer
    from jasper_tpu.table.kmer_table import (
        PAD_BUCKETS,
        ROW_U32,
        slot_words_for,
        slots_for,
    )

    from jasper_tpu.table.kmer_table import adaptive_load

    sw = slot_words_for(words_per_kmer(k))
    n_slots = slots_for(max(n_records, 1), adaptive_load(n_records, k))
    n_buckets = max(1, -(-n_slots // (ROW_U32 // sw)))
    return (n_buckets + PAD_BUCKETS) * ROW_U32 < (1 << 31)
