#!/usr/bin/env python
"""Smoke run of the polishing pipeline on the GPU, checked exactly against
plain host references.

    python chip_smoke.py            # one GPU, the phases below
    python chip_smoke.py --multi    # four GPUs: 1-device vs 4-device
                                    # replicated vs 4-device sharded runs

Phases, in one process (any failure exits non-zero):

 1. device: JAX must find a GPU (no CPU fallback); the native host
    libraries are rebuilt from the committed sources and must load;
 2. data from --seed: a bacterial-scale genome (a chromosome and a
    plasmid), 40x of 150 bp reads at 0.2% substitution error, half
    reverse-complemented, as FASTQ, and a draft with about one error per
    3 kb (substitutions, short indels, homopolymer-length errors);
 3. pipeline: ``jasper_tpu.pipeline.cli.main`` at k=37 and 2 passes, the
    reference defaults; stage times, compile time, scanner, QV, peak
    device memory, and the compiled scan step (memory analysis, whether
    its bucket-row gather is a fusion of its own, step time);
 4. references: (a) the reads counted on the host by plain numpy must give
    the .jf's (key, count) multiset and histogram; (b) the host
    PolishEngine on the same draft, table and threshold must give
    byte-identical polished FASTA, fixes.csv and QV;
 5. reuse: the CLI again with ``-j <phase-3 .jf>`` must give byte-identical
    outputs.

Data and work directories go under ``.smoke/``; the scan step's optimised
HLO goes to ``chiprun_out/smoke/``. The last line of standard output is one
JSON object: {"ok": true, "device": {"platform", "kind", "count"}}.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

from jasper_tpu.io import native as native_fastx  # noqa: E402
from jasper_tpu.io import native_jf  # noqa: E402
from jasper_tpu.table import native_table  # noqa: E402

K = 37
PASSES = 2
READ_LEN = 150
COVERAGE = 40
READ_ERR = 0.002
COVERAGE_SHAPE = 16  # gamma shape of the per-kb coverage factor (CV 25%)
DRAFT_ERR_SPACING = 3000  # one draft error per this many bases
PLASMID_BP = 100_000
HISTO_HIGH = 10000
LUT = np.frombuffer(b"ACGT", dtype=np.uint8)


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)
    print(f"  ok: {what}", flush=True)


def phase(name: str):
    print(f"\n== {name}", flush=True)
    return time.perf_counter()


def done(t0: float, name: str) -> None:
    print(f"== {name}: {time.perf_counter() - t0:.2f} s", flush=True)


# -- phase 1: device ------------------------------------------------------------


def build_native() -> None:
    r = subprocess.run(["make", "-B", "-C", os.path.join(REPO, "native")],
                       capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        raise SmokeFailure("native build failed:\n" + r.stdout + r.stderr)
    loaded = {
        "io/native.py (libjtfastx)": native_fastx.available(),
        "table/native_table.py (libjttable)": native_table.available(),
        "io/native_jf.py (libjtjf)": native_jf.available(),
    }
    for name, ok in loaded.items():
        check(ok, f"native library loaded: {name}")


# -- phase 2: data --------------------------------------------------------------


def make_reads(rng, contigs, coverage: int, read_len: int, err: float):
    """uint8 code matrix [n_reads, read_len]: starts on each contig in
    proportion to its length, with the start density varying between 1 kb
    windows (gamma, 25% coefficient of variation, as sequencing coverage
    does), substitution errors, half reverse-complemented, shuffled."""
    mats = []
    for c in contigs:
        n = int(round(coverage * len(c) / read_len))
        n_pos = len(c) - read_len + 1
        w = rng.gamma(COVERAGE_SHAPE, size=-(-n_pos // 1000))
        dens = np.repeat(w, 1000)[:n_pos]
        starts = np.searchsorted(np.cumsum(dens), rng.random(n) * dens.sum())
        mats.append(c[starts[:, None] + np.arange(read_len)[None, :]])
    mat = np.concatenate(mats)
    emask = rng.random(mat.shape) < err
    mat[emask] = (mat[emask] + rng.integers(1, 4, size=int(emask.sum()))) % 4
    rc = rng.random(len(mat)) < 0.5
    mat[rc] = 3 - mat[rc][:, ::-1]
    return mat[rng.permutation(len(mat))].astype(np.uint8)


def write_fastq(path: str, mat: np.ndarray) -> None:
    """Fixed-width records '@rNNNNNNN\\n<seq>\\n+\\n<qual>\\n', built in bulk."""
    n, L = mat.shape
    digits = len(str(max(n - 1, 0)))
    idx = np.arange(n, dtype=np.int64)
    name = np.empty((n, digits), np.uint8)
    for d in range(digits):
        name[:, digits - 1 - d] = ord("0") + (idx // 10**d) % 10
    col = lambda ch: np.full((n, 1), ord(ch), np.uint8)  # noqa: E731
    rec = np.concatenate([col("@"), col("r"), name, col("\n"), LUT[mat],
                          col("\n"), col("+"), col("\n"),
                          np.full((n, L), ord("I"), np.uint8), col("\n")],
                         axis=1)
    with open(path, "wb") as f:
        f.write(rec.tobytes())


def _homopolymer_starts(c: np.ndarray, min_len: int = 3):
    """(start, length) of every run of one base at least min_len long."""
    edge = np.flatnonzero(np.diff(c) != 0) + 1
    starts = np.concatenate([[0], edge])
    lens = np.diff(np.concatenate([starts, [len(c)]]))
    keep = lens >= min_len
    return starts[keep], lens[keep]


def make_draft(rng, c: np.ndarray, k: int, tally: dict) -> np.ndarray:
    """Copy of contig c with about one error per DRAFT_ERR_SPACING bases:
    40% substitutions, 30% 1-3 bp insertions or deletions, 30% homopolymer
    runs one base longer or shorter. Errors sit at least 2k apart."""
    n_err = max(1, len(c) // DRAFT_ERR_SPACING)
    kinds = rng.choice(3, size=n_err, p=[0.4, 0.3, 0.3])
    hp_starts, hp_lens = _homopolymer_starts(c)
    inner = (hp_starts > k) & (hp_starts + hp_lens < len(c) - k)
    hp_starts, hp_lens = hp_starts[inner], hp_lens[inner]
    edits = []
    for kind in kinds:
        if kind == 2 and len(hp_starts):
            j = int(rng.integers(len(hp_starts)))
            edits.append((int(hp_starts[j]), 2))
        else:
            edits.append((int(rng.integers(k, len(c) - k)), int(kind)))
    edits.sort()
    pieces, prev, last = [], 0, -(1 << 62)
    for pos, kind in edits:
        if pos - last < 2 * k or pos < prev:
            continue
        last = pos
        pieces.append(c[prev:pos])
        if kind == 0:  # substitution
            pieces.append(np.array([(c[pos] + rng.integers(1, 4)) % 4],
                                   np.uint8))
            prev = pos + 1
            tally["substitution"] += 1
        elif kind == 1:  # short insertion or deletion
            n = int(rng.integers(1, 4))
            if rng.random() < 0.5:
                pieces.append(rng.integers(0, 4, size=n).astype(np.uint8))
                prev = pos
                tally["insertion"] += 1
            else:
                prev = pos + n
                tally["deletion"] += 1
        else:  # homopolymer run one base longer or shorter
            if rng.random() < 0.5:
                pieces.append(c[pos:pos + 1])
                prev = pos
            else:
                prev = pos + 1
            tally["homopolymer"] += 1
    pieces.append(c[prev:])
    return np.concatenate(pieces).astype(np.uint8)


def write_fasta(path: str, named) -> None:
    with open(path, "wb") as f:
        for name, c in named:
            f.write(b">" + name.encode() + b"\n")
            txt = LUT[c].tobytes()
            for off in range(0, len(txt), 80):
                f.write(txt[off:off + 80] + b"\n")


def make_data(seed: int, genome_bp: int, ddir: str):
    rng = np.random.default_rng(seed)
    plasmid = min(PLASMID_BP, genome_bp // 10)
    contigs = [rng.integers(0, 4, size=genome_bp - plasmid, dtype=np.uint8),
               rng.integers(0, 4, size=plasmid, dtype=np.uint8)]
    reads = make_reads(rng, contigs, COVERAGE, READ_LEN, READ_ERR)
    fq = os.path.join(ddir, "reads.fq")
    write_fastq(fq, reads)
    tally = {"substitution": 0, "insertion": 0, "deletion": 0,
             "homopolymer": 0}
    drafts = [make_draft(rng, c, K, tally) for c in contigs]
    draft = os.path.join(ddir, "draft.fa")
    write_fasta(draft, zip(("chromosome", "plasmid"), drafts))
    print(f"  genome {genome_bp} bp in 2 contigs; {len(reads)} reads x "
          f"{READ_LEN} bp ({os.path.getsize(fq)} B FASTQ); draft errors "
          f"{tally} ({sum(tally.values())} total)", flush=True)
    return reads, fq, draft


# -- phase 3: pipeline ----------------------------------------------------------


class _Tee(io.TextIOBase):
    """stdout that is also kept, so the run's own log lines can be read."""

    def __init__(self, out):
        self.out = out
        self.buf = io.StringIO()

    def write(self, s):
        self.out.write(s)
        self.buf.write(s)
        return len(s)

    def flush(self):
        self.out.flush()


class CompileClock:
    """Sums JAX's compile-duration events (trace, lowering, backend)."""

    EVENTS = ("/jax/core/compile/jaxpr_trace_duration",
              "/jax/core/compile/jaxpr_to_mlir_module_duration",
              "/jax/core/compile/backend_compile_duration")

    def __init__(self):
        from jax import monitoring

        self.secs = 0.0
        self.n_backend = 0

        def listener(event, duration_secs, **kw):
            if event in self.EVENTS:
                self.secs += duration_secs
                self.n_backend += event == self.EVENTS[2]

        monitoring.register_event_duration_secs_listener(listener)


@contextlib.contextmanager
def watched(scanners: list):
    """Keep the run's stdout (it still prints) and record the scanner the
    driver's policy chose (select_scanner is wrapped, not changed)."""
    from jasper_tpu.parallel import scanner as scanner_mod

    orig = scanner_mod.select_scanner

    def spy(*a, **kw):
        s = orig(*a, **kw)
        scanners.append(s)
        return s

    tee = _Tee(sys.stdout)
    scanner_mod.select_scanner = spy
    try:
        with contextlib.redirect_stdout(tee):
            yield tee.buf
    finally:
        scanner_mod.select_scanner = orig


def run_cli(argv, scanners: list) -> str:
    """cli.main in-process; returns its log."""
    from jasper_tpu.pipeline import cli

    with watched(scanners) as buf:
        rc = cli.main(argv)
    if rc != 0:
        raise SmokeFailure(f"jasper-tpu {' '.join(argv)} exited {rc}")
    return buf.getvalue()


def qv_of(log: str) -> tuple[str, str]:
    before = re.findall(r"Before Polishing: Q value = (\S+)", log)
    after = re.findall(r"After Polishing: Q value = (\S+)", log)
    if not (before and after):
        raise SmokeFailure("QV lines missing from the run's log")
    return before[-1], after[-1]


def outputs(wd: str, draft: str) -> dict:
    base = os.path.basename(draft)
    names = {"polished": f"{base}.polished.fasta", "fixes": f"{base}.fixes.csv",
             "histogram": f"jfhisto{K}.csv", "threshold": "threshold.txt"}
    out = {}
    for key, name in names.items():
        with open(os.path.join(wd, name), "rb") as f:
            out[key] = f.read()
    return out


def scan_step_report(tab, k: int, tile: int, thr: int, draft_codes,
                     out_dir: str) -> None:
    """memory_analysis of the scan step at the run's tile and at half of it
    (their difference gives bytes per lane), whether the bucket-row gather
    of lookup_kmers is a fusion of its own, and the step's time."""
    import jax
    import jax.numpy as jnp

    from jasper_tpu.parallel.scanner import SCAN_FIXED_BYTES, SCAN_LANE_BYTES
    from jasper_tpu.polish.window import scan_window_packed

    def compiled_at(t):
        codes = jax.ShapeDtypeStruct((t + k - 1,), jnp.uint8)
        return scan_window_packed.lower(tab, codes, jnp.uint32(thr),
                                        k=k).compile()

    totals = {}
    for t in (tile, tile // 2):
        ma = compiled_at(t).memory_analysis()
        total = (ma.argument_size_in_bytes + ma.output_size_in_bytes
                 + ma.temp_size_in_bytes - ma.alias_size_in_bytes)
        totals[t] = total
        print(f"  scan step memory_analysis at tile {t}: argument "
              f"{ma.argument_size_in_bytes} B, output "
              f"{ma.output_size_in_bytes} B, temp {ma.temp_size_in_bytes} B, "
              f"alias {ma.alias_size_in_bytes} B, generated code "
              f"{ma.generated_code_size_in_bytes} B", flush=True)
    lane = (totals[tile] - totals[tile // 2]) / (tile - tile // 2)
    fixed = totals[tile] - tab.nbytes - lane * tile
    print(f"  scan working set beyond the table: {lane:.1f} B/lane + "
          f"{fixed:.0f} B fixed (tile_for_table assumes {SCAN_LANE_BYTES} "
          f"B/lane + {SCAN_FIXED_BYTES} B)", flush=True)
    check(lane <= SCAN_LANE_BYTES and fixed <= SCAN_FIXED_BYTES,
          "scan working set within tile_for_table's model")

    hlo = compiled_at(tile).as_text()
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "scan_step_hlo.txt")
    with open(path, "w") as f:
        f.write(hlo)
    for line in gather_fusions(hlo, tab.shape):
        print("  " + line, flush=True)
    print(f"  optimised HLO of the scan step: {path}", flush=True)

    chunk = np.full(tile + k - 1, 255, np.uint8)
    m = min(len(draft_codes), tile + k - 1)
    chunk[:m] = draft_codes[:m]
    chunk = jnp.asarray(chunk)
    thr_d = jnp.uint32(thr)
    jax.block_until_ready(scan_window_packed(tab, chunk, thr_d, k=k))
    n = 10
    t0 = time.perf_counter()
    for _ in range(n):
        out = scan_window_packed(tab, chunk, thr_d, k=k)
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / n
    print(f"  scan step time at tile {tile}: {dt * 1e3:.3f} ms per call "
          f"({tile / dt / 1e6:.1f} M windows/s; host clock around {n} calls "
          f"ending in block_until_ready)", flush=True)


def gather_fusions(hlo: str, tab_shape) -> list[str]:
    """For every gather that reads the table in optimised HLO: the
    computation it sits in and, for a fusion, the fusion's kind and output
    shape (a u32[B,64] output means the bucket rows are written out)."""
    comps, cur, name = {}, [], None
    for line in hlo.splitlines():
        m = re.match(r"^(?:ENTRY\s+)?%?([\w.\-]+)\s.*\{\s*$", line)
        if m and not line.startswith(" "):
            name, cur = m.group(1), []
            comps[name] = cur
        elif name is not None:
            cur.append(line)
    tab_ty = f"u32[{tab_shape[0]},{tab_shape[1]}]"
    callers = {}
    for cname, lines in comps.items():
        for ln in lines:
            m = re.search(
                r"=\s*(.+?)\s+fusion\(.*kind=(\w+).*calls=%?([\w.\-]+)", ln)
            if m:
                callers[m.group(3)] = (cname, m.group(2), m.group(1))
    out = []
    for cname, lines in comps.items():
        params = {re.search(r"%?([\w.\-]+)\s*=", ln).group(1)
                  for ln in lines if "parameter(" in ln and tab_ty in ln}
        for ln in lines:
            if " gather(" not in ln:
                continue
            if tab_ty not in ln and not any(f"%{p}" in ln for p in params):
                continue
            shape = re.search(r"=\s*(\S+)\s+gather\(", ln).group(1)
            if cname in callers:
                parent, kind, fshape = callers[cname]
                out.append(f"gather {shape} inside fusion {cname} "
                           f"(kind={kind}, output {fshape}, in {parent})")
            else:
                out.append(f"gather {shape} unfused in {cname}")
    return out or ["no gather reading the table found"]


def pipeline_phase(wd: str, fq: str, draft: str, clock):
    import jax

    scanners: list = []
    c0, n0 = clock.secs, clock.n_backend
    t0 = time.perf_counter()
    log = run_cli(["-a", draft, "-r", fq, "-k", str(K), "-p", str(PASSES),
                   "--workdir", wd], scanners)
    wall = time.perf_counter() - t0
    print(f"  pipeline wall {wall:.2f} s, of which compile "
          f"{clock.secs - c0:.2f} s ({clock.n_backend - n0} programs)",
          flush=True)
    check(len(scanners) == 1, "the driver chose one scanner")
    sc = scanners[0]
    print(f"  scanner: {type(sc).__name__}, tile {getattr(sc, 'tile', None)}",
          flush=True)
    q = qv_of(log)
    print(f"  QV before {q[0]}, after {q[1]}", flush=True)
    stats = jax.local_devices()[0].memory_stats() or {}
    print(f"  device peak_bytes_in_use {stats.get('peak_bytes_in_use')} of "
          f"bytes_limit {stats.get('bytes_limit')}", flush=True)
    check(float(q[1]) > float(q[0]), "polishing raised the QV")
    return log, sc, q


# -- phase 4: references --------------------------------------------------------


def host_count(reads: np.ndarray, k: int, chunk: int = 1 << 16):
    """Canonical k-mer counts of the read matrix, in plain numpy and apart
    from the package: each k-mer as a 2k-bit integer (first base most
    significant), split into its low 64 bits and the rest, canonical as the
    smaller of itself and its reverse complement. Returns (hi, lo, counts)
    sorted by (hi, lo)."""
    assert 32 < k <= 40, "hi holds at most 16 bits"
    n, L = reads.shape
    nw = L - k + 1
    his, los = [], []
    for s in range(0, n, chunk):
        m = reads[s:s + chunk].astype(np.uint64)
        f_lo = np.zeros((len(m), nw), np.uint64)
        f_hi = np.zeros_like(f_lo)
        r_lo = np.zeros_like(f_lo)
        r_hi = np.zeros_like(f_lo)
        for p in range(k):
            b = m[:, p:p + nw]
            fb, rb = 2 * (k - 1 - p), 2 * p  # base p's bit in fwd and rc
            if fb >= 64:
                f_hi |= b << np.uint64(fb - 64)
            else:
                f_lo |= b << np.uint64(fb)
            if rb >= 64:
                r_hi |= (3 - b) << np.uint64(rb - 64)
            else:
                r_lo |= (3 - b) << np.uint64(rb)
        fwd = (f_hi < r_hi) | ((f_hi == r_hi) & (f_lo <= r_lo))
        his.append(np.where(fwd, f_hi, r_hi).astype(np.uint16).ravel())
        los.append(np.where(fwd, f_lo, r_lo).ravel())
    hi = np.concatenate(his)
    lo = np.concatenate(los)
    del his, los
    hi, lo = sort_keys(hi, lo)
    new = np.ones(len(lo), bool)
    new[1:] = (lo[1:] != lo[:-1]) | (hi[1:] != hi[:-1])
    starts = np.flatnonzero(new)
    counts = np.diff(np.append(starts, len(lo))).astype(np.uint64)
    return hi[starts], lo[starts], counts


def sort_keys(hi, lo, *more):
    order = np.argsort(lo)
    order = order[np.argsort(hi[order], kind="stable")]
    return (hi[order], lo[order]) + tuple(x[order] for x in more)


def histogram_text(counts: np.ndarray) -> bytes:
    hist = np.bincount(np.minimum(counts, HISTO_HIGH + 1).astype(np.int64),
                       minlength=HISTO_HIGH + 2)
    return "".join(f"{c} {hist[c]}\n" for c in range(1, HISTO_HIGH + 2)
                   if hist[c]).encode()


def check_counts(ref, jf_path: str, histo: bytes) -> None:
    from jasper_tpu.io.jf import read_any_jf

    hi, lo, counts = ref
    k, keys, jcounts, _ = read_any_jf(jf_path)
    check(k == K, f".jf holds k={k}")
    jlo = keys[:, 0].astype(np.uint64) | (keys[:, 1].astype(np.uint64) << 32)
    jhi, jlo, jcounts = sort_keys(keys[:, 2].astype(np.uint16), jlo,
                                  np.asarray(jcounts, np.uint64))
    print(f"  host count: {len(lo)} distinct 37-mers, "
          f"{int(counts.sum())} windows; .jf: {len(jlo)} records", flush=True)
    check(np.array_equal(jhi, hi) and np.array_equal(jlo, lo),
          ".jf keys == host-counted keys")
    check(np.array_equal(jcounts, counts), ".jf counts == host counts")
    check(histogram_text(counts) == histo,
          f"jfhisto{K}.csv == histogram of the host counts")


def host_table_of(ref):
    """HostKmerTable holding the host counts (records in (mix32, key)
    order, as from_sorted_run takes them)."""
    from jasper_tpu.ops.hashing import hash_words_np
    from jasper_tpu.table.host_table import HostKmerTable

    hi, lo, counts = ref
    keys = np.stack([(lo & np.uint64(0xFFFFFFFF)).astype(np.uint32),
                     (lo >> np.uint64(32)).astype(np.uint32),
                     hi.astype(np.uint32)], axis=1)
    h = hash_words_np(keys)
    order = np.argsort(h, kind="stable")  # keys already ascending
    return HostKmerTable.from_sorted_run(
        K, keys[order], np.minimum(counts, 0xFFFFFFFF).astype(np.uint32)[order],
        h=h[order])


def host_polish(draft: str, host_table, thr: int, wd: str, threads: int = 2):
    """The driver's split / polish / join with the host PolishEngine (the
    plain reference engine: polish_file's default engine_cls)."""
    from jasper_tpu.io.fastx import read_fasta
    from jasper_tpu.pipeline import driver
    from jasper_tpu.polish.engine import CountSource
    from jasper_tpu.polish.runner import polish_file

    query_fn = os.path.basename(draft)
    bs = driver.compute_batch_size(draft, threads, 0)
    batches = driver.split_batches(draft, bs, wd, query_fn)
    counts = CountSource(host_table)
    fixed = []
    for bp in batches:
        bn = os.path.basename(bp)
        polish_file(bp, counts, K, thr, PASSES, fix=True, test=True,
                    fout=f"{bn}.fix.csv", fixedout=f"{bn}.fixed.fa",
                    workdir=wd)
        fixed.append(os.path.join(wd, f"_iter{PASSES - 1}_{bn}.fixed.fa"))
    polished = os.path.join(wd, f"{query_fn}.polished.fasta")
    driver.join_polished(fixed, bs, list(read_fasta(draft)), polished)
    csvs = sorted(os.path.join(wd, p) for p in os.listdir(wd)
                  if re.match(r"_iter\d+_.*\.fix\.csv$", p))
    driver.join_fix_csvs(csvs, os.path.join(wd, f"{query_fn}.fixes.csv"))
    qv = tuple(driver.qv_from_tallies(
        *driver.read_qv_helper(os.path.join(wd, f"{i}qValCalcHelper.csv")), K)
        for i in (0, PASSES))
    return qv


# -- driver ---------------------------------------------------------------------


def fresh_dir(path: str) -> str:
    shutil.rmtree(path, ignore_errors=True)
    os.makedirs(path)
    return path


def run_smoke(args, clock) -> None:
    """Phases 2-5 (phase 1 is main's)."""
    from jasper_tpu.count.histogram import threshold_from_histogram
    from jasper_tpu.io.fastx import read_fasta
    from jasper_tpu.ops.codes import encode
    from jasper_tpu.parallel.scanner import push_table_sliced

    root = fresh_dir(os.path.join(REPO, ".smoke"))
    out_dir = os.path.join(REPO, "chiprun_out", "smoke")

    t0 = phase("phase 2: data")
    reads, fq, draft = make_data(args.seed, int(args.genome_mbp * 1e6),
                                 fresh_dir(os.path.join(root, "data")))
    done(t0, "phase 2")

    t0 = phase("phase 3: pipeline on the device")
    wd = fresh_dir(os.path.join(root, "run"))
    log, scanner, qv = pipeline_phase(wd, fq, draft, clock)
    got = outputs(wd, draft)
    jf_path = os.path.join(wd, f"mer_counts{K}.jf")
    done(t0, "phase 3")

    t0 = phase("phase 4a: counting against a host count")
    ref = host_count(reads, K)
    del reads
    check_counts(ref, jf_path, got["histogram"])
    thr = threshold_from_histogram(
        [tuple(map(int, ln.split())) for ln in
         histogram_text(ref[2]).decode().splitlines()])
    check(str(thr).encode() == got["threshold"],
          f"threshold {thr} from the host histogram == threshold.txt")
    done(t0, "phase 4a")

    t0 = phase("phase 4b: polishing against the host PolishEngine")
    host_table = host_table_of(ref)
    del ref
    qv_ref = host_polish(draft, host_table, thr,
                         fresh_dir(os.path.join(root, "host")))
    base = os.path.basename(draft)
    for key, name in (("polished", f"{base}.polished.fasta"),
                      ("fixes", f"{base}.fixes.csv")):
        with open(os.path.join(root, "host", name), "rb") as f:
            check(f.read() == got[key], f"{name} == host PolishEngine's")
    check(qv_ref == qv, f"QV {qv} == host PolishEngine's {qv_ref}")
    done(t0, "phase 4b")

    t0 = phase("phase 5: reuse of the .jf")
    wd2 = fresh_dir(os.path.join(root, "reuse"))
    log2 = run_cli(["-a", draft, "-j", jf_path, "-k", str(K), "-p",
                    str(PASSES), "--workdir", wd2], [])
    got2 = outputs(wd2, draft)
    for key in got:
        check(got2[key] == got[key], f"reuse run {key} == first run's")
    check(qv_of(log2) == qv, "reuse run QV == first run's")
    done(t0, "phase 5")

    t0 = phase("phase 3b: the compiled scan step (of the phase-3 run)")
    tab = push_table_sliced(host_table.tab)
    codes = encode(next(iter(read_fasta(draft).values()))[:scanner.tile + K])
    scan_step_report(tab, K, scanner.tile, thr, codes, out_dir)
    del tab
    done(t0, "phase 3b")


def run_multi(args, clock, n_dev: int) -> None:
    """1-device, n-device replicated and n-device sharded pipeline runs on
    the same data; every output must be byte-identical."""
    from jasper_tpu.parallel.scanner import ShardedDeviceScanner
    from jasper_tpu.pipeline.driver import run_pipeline
    from jasper_tpu.polish.device_engine import DeviceScanner

    root = fresh_dir(os.path.join(REPO, ".smoke"))
    t0 = phase("multi: data")
    _reads, fq, draft = make_data(args.seed, int(args.genome_mbp * 1e6),
                                  fresh_dir(os.path.join(root, "data")))
    del _reads
    done(t0, "data")
    results = {}
    for name, nd, force in (("1 device", 1, None),
                            (f"{n_dev} devices replicated", n_dev, None),
                            (f"{n_dev} devices sharded", n_dev, "sharded")):
        t0 = phase(f"multi: {name}")
        os.environ.pop("JASPER_TPU_SCANNER", None)
        if force:
            os.environ["JASPER_TPU_SCANNER"] = force
        wd = fresh_dir(os.path.join(root, name.replace(" ", "_")))
        scanners: list = []
        c0 = clock.secs
        try:
            with watched(scanners) as buf:
                res = run_pipeline(assembly=draft, reads=[fq], k=K,
                                   passes=PASSES, workdir=wd, num_devices=nd)
        finally:
            os.environ.pop("JASPER_TPU_SCANNER", None)
        log = buf.getvalue()
        sc = scanners[0]
        if force == "sharded":
            check(isinstance(sc, ShardedDeviceScanner)
                  and sc.mesh.devices.size == nd,
                  f"{name}: ShardedDeviceScanner over {nd} devices")
        else:
            n_mesh = 1 if sc.mesh is None else sc.mesh.devices.size
            check(isinstance(sc, DeviceScanner) and n_mesh == nd,
                  f"{name}: DeviceScanner over {nd} device(s)")
        counted = re.findall(r"Counting data-parallel over (\d+) devices", log)
        check((int(counted[0]) if counted else 1) == nd,
              f"{name}: counted over {nd} device(s)")
        out = outputs(wd, draft)
        with open(res["db"], "rb") as f:
            out["jf"] = f.read()
        out["qv"] = repr((res["q_before"], res["q_after"])).encode()
        print(f"  QV {res['q_before']} -> {res['q_after']}; compile "
              f"{clock.secs - c0:.2f} s", flush=True)
        results[name] = out
        done(t0, name)
    base_name = next(iter(results))
    for name, out in list(results.items())[1:]:
        for key in out:
            check(out[key] == results[base_name][key],
                  f"{name}: {key} == {base_name}'s")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--genome-mbp", type=float, default=5.0,
                   help="genome size in Mbp (default 5, bacterial scale)")
    p.add_argument("--multi", action="store_true",
                   help="run the four-device comparison instead")
    args = p.parse_args(argv)
    n_dev = 4 if args.multi else 1
    try:
        t0 = phase("phase 1: device")
        import jax

        from jasper_tpu.utils.jaxenv import (
            gpu_devices,
            nvidia_smi,
            setup_compilation_cache,
        )

        try:
            devs = gpu_devices(n_dev)
        except RuntimeError as e:
            raise SmokeFailure(str(e)) from None
        smi = nvidia_smi()
        for line in smi:
            print(f"  nvidia-smi: {line}", flush=True)
        print(f"  JAX: {len(devs)} x {devs[0].device_kind} "
              f"({devs[0].platform}), jax {jax.__version__}", flush=True)
        print(f"  compile cache: {setup_compilation_cache()}", flush=True)
        build_native()
        clock = CompileClock()
        done(t0, "phase 1")
        if args.multi:
            run_multi(args, clock, n_dev)
        else:
            run_smoke(args, clock)
    except SmokeFailure as e:
        print(f"FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    print(f"\ncard: {'; '.join(smi)}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
