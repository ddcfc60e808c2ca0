"""Production multi-device scanners + mesh/scanner selection policy.

The reference's whole P5 deployment is xargs -P processes sharing one
mmapped .jf (reference src/jasper.sh:206-215). Here select_scanner()
chooses among three regimes:

  * table fits one device's budget -> replicated table, data-parallel tiles
    (polish.device_engine.DeviceScanner, over a ("data",) mesh when more
    than one device is asked for);
  * table exceeds one device -> hash-prefix-sharded table, window tiles
    data-parallel on the "data" axis, lookups routed all-to-all on the
    "table" axis (ShardedDeviceScanner below, over sharded_scan_fn);
  * table exceeds every device's share even at full sharding (one device:
    any table past its budget) -> bucket-range partitions streamed through
    one device (PartitionedDeviceScanner).

All produce the same ContigScan arrays consumed by DevicePolishEngine, so
the byte-exact repair replay is identical in every regime. The driver
(pipeline.driver.run_pipeline) and the dryrun entry (__graft_entry__)
call this same policy. Device budgets come from jasper_tpu.utils.budgets.
"""

from __future__ import annotations

import numpy as np

from jasper_tpu.parallel.sharded_table import (
    build_sharded,
    make_mesh,
    sharded_scan_fn,
)
from jasper_tpu.utils import budgets

# scan-program working set of scan_window_packed at k=37 on top of the
# resident table, from compiled.memory_analysis() on an H100 80GB HBM3
# (PERF.md, PR 1 findings): 41.2 B per scanned lane plus 68,756 B fixed,
# rounded up here
SCAN_LANE_BYTES = 42
SCAN_FIXED_BYTES = 1 << 20


class ShardedDeviceScanner:
    """DeviceScanner drop-in whose count table is sharded across the mesh's
    "table" axis. prepare() contract matches polish.device_engine."""

    def __init__(self, host_table, k: int, mesh, divisor: int = 50,
                 tile: int = 1 << 18):
        import jax.numpy as jnp

        self.k = int(k)
        self.divisor = divisor
        self.tile = tile
        self.mesh = mesh
        self.host_table = host_table
        self.n_data = mesh.shape["data"]
        self.n_table = mesh.shape["table"]
        self.d_total = self.n_data * self.n_table

        keys, counts = host_table.items()
        if len(keys) == 0:  # empty DB: one inactive lane keeps shapes sane
            keys = np.zeros((1, host_table.W), dtype=np.uint32)
            counts = np.zeros(1, dtype=np.uint32)
        # local sub-tables sized for a uniform shard at the host table's own
        # load factor (top-bit sharding is uniform under mix32)
        local_slots = max(
            1024, int(2 ** np.ceil(np.log2(max(len(keys), 1) / self.n_table / 0.6)))
        )
        self.tabs = build_sharded(mesh, jnp.asarray(keys),
                                  jnp.asarray(counts), local_slots)
        self._scan = sharded_scan_fn(mesh, self.k, tile + self.k - 1, divisor)
        # host-fallback accounting (lanes answered off-device after routing
        # overflow); tests assert this stays tiny under adversarial skew
        self.fallback_lanes = 0
        self.scanned_lanes = 0

    def prepare(self, seq: str, solid_thre: int):
        import jax.numpy as jnp

        from jasper_tpu.ops.codes import encode
        from jasper_tpu.polish.device_engine import ContigScan

        k, tile, D = self.k, self.tile, self.d_total
        codes = encode(seq)
        L = len(codes)
        n = L - k + 1
        if n <= 0:
            z = np.zeros(0, bool)
            return ContigScan(np.zeros(0, np.uint32), z, z)
        counts = np.empty(n, np.uint32)
        thre = jnp.full((D,), solid_thre, dtype=jnp.uint32)
        pos = 0
        while pos < n:
            chunks = np.full((D, tile + k - 1), 255, dtype=np.uint8)
            for d in range(D):
                s = pos + d * tile
                mm = min(tile, max(0, n - s))
                if mm:
                    chunks[d, : mm + k - 1] = codes[s : s + mm + k - 1]
            c, _b, _r, ovf, qkeys, unres = self._scan(
                self.tabs, jnp.asarray(chunks), thre
            )
            c = np.asarray(c)
            self.scanned_lanes += min(D * tile, n - pos)
            if int(ovf) > 0:
                # residual distinct-key routing overflow: answer those lanes
                # from the host table (exact, rare). np.asarray of a device
                # array is read-only — copy before patching lanes.
                c = np.array(c)
                u = np.asarray(unres)
                qk = np.asarray(qkeys)
                for d in range(D):
                    ui = np.flatnonzero(u[d])
                    if len(ui):
                        c[d, ui] = self.host_table.lookup_words(qk[d][ui])
                        self.fallback_lanes += len(ui)
            for d in range(D):
                s = pos + d * tile
                mm = min(tile, max(0, n - s))
                if mm:
                    counts[s : s + mm] = c[d, :mm]
            pos += D * tile

        # classification on host, identical to polish.window.scan_window_tiled
        bad = (codes > 3).astype(np.int32)
        cs = np.concatenate([[0], np.cumsum(bad)])
        valid = (cs[k : n + k] - cs[:n]) == 0
        counts[~valid] = 0
        below = valid & (counts < np.uint32(solid_thre))
        idx = np.maximum(np.arange(n) - k, 0)
        prev = counts[idx].astype(np.uint64)
        ceil_prev = prev // self.divisor + (prev % self.divisor != 0)
        rel = valid & ~below & (np.arange(n) > 0) & (counts < ceil_prev)
        prev_ok = valid[np.maximum(np.arange(n) - k, 0)]
        unsafe = (~valid) | below | rel | (~prev_ok)
        from jasper_tpu.polish.device_engine import ContigScan

        return ContigScan(counts, valid, unsafe)


def _scan_counts_ranged_fn(k: int, n_buckets_global: int, esc_cap: int = 8192):
    """jit: (tab_slice, codes, b0) -> (c16, esc_idx, esc_val, n_esc) —
    window counts against ONE bucket-range slice of the global table
    (lookup_kmers ranged mode); out-of-range and invalid lanes read 0.
    b0 is traced, so one program serves every partition slice."""
    import functools

    import jax
    import jax.numpy as jnp

    from jasper_tpu.ops.kmer import canonical_windows_fast
    from jasper_tpu.table.kmer_table import lookup_kmers

    @jax.jit
    def scan(tab_slice, codes, b0):
        keys, valid = canonical_windows_fast(jnp, codes, k)
        counts = lookup_kmers(tab_slice, keys, valid,
                              n_buckets_global=n_buckets_global, home_base=b0)
        n = counts.shape[0]
        c16 = jnp.minimum(counts, jnp.uint32(0xFFFF)).astype(jnp.uint16)
        over = counts > jnp.uint32(0xFFFF)
        n_esc = jnp.sum(over.astype(jnp.uint32))
        eidx = jnp.nonzero(over, size=esc_cap, fill_value=n)[0].astype(jnp.uint32)
        safe = jnp.minimum(eidx, jnp.uint32(n - 1)).astype(jnp.int32)
        evals = jnp.where(eidx < n, counts[safe], 0)
        return c16, eidx, evals, n_esc

    return scan


class PartitionedDeviceScanner:
    """Beyond-HBM polish scan on ONE chip: the table streams through the
    device as P bucket-range slices, every window batch scans against each
    resident slice, and counts combine with an elementwise max (each key
    lives in exactly one partition; the others read 0).

    This is the single-chip analog of the reference's out-of-core query —
    mmapped sorted file + page cache (jf:include/jellyfish/
    binary_dumper.hpp:112-213, mapped_file.hpp) — which let a human-scale
    DB polish on one box. Bucket ranges slice the HOST table directly (a
    key's probe chain lies within [home, home + PAD_BUCKETS], so a slice
    padded by PAD_BUCKETS rows is self-contained); no per-partition rebuild.
    Classification runs on host after the combine, identical to
    ShardedDeviceScanner. Costs P scans + P slice pushes per prepare();
    the replicated scanner remains the fast path for tables that fit.
    """

    def __init__(self, host_table, k: int, hbm_budget: int,
                 divisor: int = 50, tile: int = 1 << 22):
        from jasper_tpu.table.kmer_table import PAD_BUCKETS, ROW_U32

        self.k = int(k)
        self.divisor = divisor
        self.tile = tile
        self.host_table = host_table
        self.PAD = PAD_BUCKETS
        self.row_u32 = ROW_U32
        N = host_table.n_buckets
        usable = max(PAD_BUCKETS + 1,
                     hbm_budget // (ROW_U32 * 4) - PAD_BUCKETS)
        self.P = max(1, -(-N // usable))
        self.part_rows = -(-N // self.P)
        self.n_global = N
        self.tile = tile_for_table((self.part_rows + PAD_BUCKETS) * ROW_U32
                                   * 4, tile)
        self._scan = _scan_counts_ranged_fn(self.k, N)

    def _slice_rows(self, p: int):
        b0 = p * self.part_rows
        end = min(b0 + self.part_rows + self.PAD,
                  self.n_global + self.PAD)
        sl = self.host_table.tab[b0:end]
        want = self.part_rows + self.PAD
        if sl.shape[0] < want:
            sl = np.concatenate(
                [sl, np.zeros((want - sl.shape[0], sl.shape[1]),
                              dtype=sl.dtype)])
        return b0, sl

    def prepare(self, seq: str, solid_thre: int):
        import jax.numpy as jnp

        from jasper_tpu.ops.codes import encode
        from jasper_tpu.polish.device_engine import ContigScan

        k, tile = self.k, self.tile
        codes = encode(seq)
        L = len(codes)
        n = L - k + 1
        if n <= 0:
            z = np.zeros(0, bool)
            return ContigScan(np.zeros(0, np.uint32), z, z)
        counts = np.zeros(n, np.uint32)
        for p in range(self.P):
            b0, sl = self._slice_rows(p)
            tab_p = push_table_sliced(sl)
            b0j = jnp.uint32(b0)
            pos = 0
            pending = None

            def _land(s, m, outs):
                c16, eidx, evals, n_esc = outs
                c = np.asarray(c16).astype(np.uint32)
                ne = int(n_esc)
                if ne:
                    ei = np.asarray(eidx).astype(np.int64)[:ne]
                    c[ei] = np.asarray(evals)[:ne]
                counts[s : s + m] = np.maximum(counts[s : s + m], c[:m])

            while pos < n or pending is not None:
                nxt = None
                if pos < n:
                    m = min(tile, n - pos)
                    chunk = np.full(tile + k - 1, 255, dtype=np.uint8)
                    chunk[: m + k - 1] = codes[pos : pos + m + k - 1]
                    outs = self._scan(tab_p, jnp.asarray(chunk), b0j)
                    for a in outs[:1]:
                        a.copy_to_host_async()
                    nxt = (pos, m, outs)
                    pos += m
                if pending is not None:
                    _land(*pending)
                pending = nxt
            del tab_p

        # classification on host, identical to ShardedDeviceScanner
        bad = (codes > 3).astype(np.int32)
        cs = np.concatenate([[0], np.cumsum(bad)])
        valid = (cs[k : n + k] - cs[:n]) == 0
        counts[~valid] = 0
        below = valid & (counts < np.uint32(solid_thre))
        idx = np.maximum(np.arange(n) - k, 0)
        prev = counts[idx].astype(np.uint64)
        ceil_prev = prev // self.divisor + (prev % self.divisor != 0)
        rel = valid & ~below & (np.arange(n) > 0) & (counts < ceil_prev)
        prev_ok = valid[idx]
        unsafe = (~valid) | below | rel | (~prev_ok)
        from jasper_tpu.polish.device_engine import ContigScan

        return ContigScan(counts, valid, unsafe)


def tile_for_table(table_bytes: int, tile: int,
                   program_bytes: int | None = None) -> int:
    """Largest power-of-two scan tile (at most ``tile``) whose scan program
    fits beside a resident table of table_bytes: the table plus the
    working set measured from the compiled scan (SCAN_LANE_BYTES per lane
    on top of SCAN_FIXED_BYTES) within the scan program's budget."""
    if program_bytes is None:
        program_bytes = budgets.scan_program_bytes()
    budget_lanes = max(1 << 18, (program_bytes - table_bytes
                                 - SCAN_FIXED_BYTES) // SCAN_LANE_BYTES)
    t = 1 << 18
    while t * 2 <= min(tile, budget_lanes):
        t *= 2
    return t


def local_data_mesh(num_devices: int | None = None, devices=None):
    """1-axis ("data",) mesh over this host's local devices for
    data-parallel counting (count_reads mesh=...); None when only one
    device is visible (the single-device path needs no mesh)."""
    import jax

    devices = list(devices if devices is not None else jax.local_devices())
    if num_devices is not None:
        devices = devices[: max(1, num_devices)]
    if len(devices) < 2:
        return None
    from jax.sharding import Mesh

    return Mesh(np.array(devices), ("data",))


def mesh_for_table(table_bytes: int, num_devices: int,
                   hbm_budget: int | None = None):
    """Pick (n_table, n_data): smallest power-of-two table axis whose shard
    fits the per-device budget; remaining devices go data-parallel."""
    if hbm_budget is None:
        hbm_budget = budgets.hbm_table_budget()
    n_table = 1
    while n_table < num_devices and table_bytes // n_table > hbm_budget:
        n_table *= 2
    n_data = max(1, num_devices // n_table)
    return n_table, n_data


def select_scanner(host_table, k: int, num_devices: int | None = None,
                   hbm_budget: int | None = None, tile: int = 1 << 22,
                   devices=None, device_tab=None):
    """The driver's scanner policy. Returns a scanner object with
    .prepare(seq, thre) -> ContigScan.

    device_tab: optional lookup table ALREADY on device (the counting
    finish builds it from the resident run) — skips re-pushing the
    multi-GB host table over the h2d link in the replicated regime."""
    import jax
    import jax.numpy as jnp

    from jasper_tpu.polish.device_engine import DeviceScanner

    import os

    if hbm_budget is None:
        hbm_budget = budgets.hbm_table_budget()
    env_tile = os.environ.get("JASPER_TPU_SCAN_TILE")
    if env_tile:
        tile = int(env_tile)
    # local devices: under multi-host (parallel.distributed) each host scans
    # its own batch shard on its own chips with the table replicated per
    # host — the analog of the reference's per-node shared page cache
    devices = list(devices if devices is not None else jax.local_devices())
    if num_devices is None:
        num_devices = len(devices)
    num_devices = max(1, min(num_devices, len(devices)))
    table_bytes = host_table.tab.nbytes
    n_table, n_data = mesh_for_table(table_bytes, num_devices, hbm_budget)
    force = os.environ.get("JASPER_TPU_SCANNER")  # test/ops override
    if force == "replicated":
        n_table, n_data = 1, num_devices
    elif force == "sharded":
        n_table = 1 << (num_devices.bit_length() - 1)
        n_data = max(1, num_devices // n_table)
    elif force == "partitioned" or (
        not force and table_bytes // n_table > hbm_budget
    ):
        # the table exceeds every chip's share even at max sharding (on one
        # chip: any replicated push) — stream it through as bucket-range
        # partitions instead; the single-chip out-of-core regime
        return PartitionedDeviceScanner(host_table, k, hbm_budget, tile=tile)
    if n_table > 1:
        mesh = make_mesh(n_table, n_data, devices=devices)
        return ShardedDeviceScanner(host_table, k, mesh,
                                    tile=max(1 << 14, tile // n_data))
    mesh = None
    if num_devices > 1:
        from jax.sharding import Mesh

        mesh = Mesh(np.array(devices[:num_devices]), ("data",))
    if device_tab is not None:
        tab = device_tab
    else:
        tab = push_table_sliced(host_table.tab)
    return DeviceScanner(tab, k, tile=tile_for_table(table_bytes, tile),
                         mesh=mesh)


def push_table_sliced(tab_np, slice_bytes: int = 512 << 20):
    """Host table -> device, in donated dynamic_update_slice chunks.

    Uploading row slices into a donated device buffer bounds the transfer's
    peak at table + one slice, whatever layout copy the backend would make
    of a whole-table jnp.asarray (unmeasured on the H100)."""
    import functools

    import jax
    import jax.numpy as jnp

    if tab_np.nbytes <= slice_bytes:
        return jnp.asarray(tab_np)
    rows_per = max(1, slice_bytes // max(1, tab_np.shape[1] * 4))

    @functools.partial(jax.jit, donate_argnums=(0,))
    def _upd(buf, part, start):
        return jax.lax.dynamic_update_slice(buf, part, (start, 0))

    # _upd compiles once per part shape (full slice + ragged tail = 2)
    buf = jnp.zeros(tab_np.shape, dtype=tab_np.dtype)
    for r0 in range(0, tab_np.shape[0], rows_per):
        part = jnp.asarray(np.ascontiguousarray(tab_np[r0 : r0 + rows_per]))
        buf = _upd(buf, part, jnp.int32(r0))
    return buf
