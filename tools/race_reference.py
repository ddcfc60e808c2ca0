#!/usr/bin/env python
"""End-to-end race: reference jasper.sh (real jellyfish 2.3.0 + real SWIG
dna_jellyfish, built by tools/build_baseline.sh) vs jasper-tpu, on the same
synthetic E. coli-scale input (BASELINE.json config 1 shape). Asserts
byte-parity of the polished FASTA and fixes.csv, and prints wall-clock JSON.

The ONE shared component is the Bio.pairwise2 shim (tests/oracle/Bio):
Biopython is not installed and cannot be fetched (zero egress), so both
sides use jasper_tpu.utils.pairwise for nb>k patch alignment — see
PARITY.md "Known residual risk".

Usage: python tools/race_reference.py [genome_kb=2000] [coverage=40]
           [k=25] [passes=2] [--keep]
Work dir: .race/ (gitignored).
"""

import json
import os
import re
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = os.path.join(REPO, ".baseline")
RACE = os.environ.get("JT_RACE_DIR", os.path.join(REPO, ".race"))


def log(msg):
    print(f"[race] {msg}", file=sys.stderr, flush=True)


def make_data(genome_kb: int, coverage: int, seed: int = 7):
    """Vectorized synthetic data: genome, draft with rotating sub/del/ins
    errors every ~4 kb, and reads with hotspot + random errors."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n = genome_kb * 1000
    LUT = np.frombuffer(b"ACGT", dtype=np.uint8)
    gcodes = rng.integers(0, 4, size=n).astype(np.uint8)
    genome_b = LUT[gcodes].tobytes()

    # draft with an error every ~4 kb, rotating sub/del/ins
    draft = bytearray()
    prev = 0
    kinds = ["sub", "del", "ins"]
    for ei, pos in enumerate(range(2000, n - 4000, 4000)):
        draft += genome_b[prev:pos]
        kind = kinds[ei % 3]
        if kind == "sub":
            draft[-1] = LUT[(gcodes[pos - 1] + 1) % 4]
        elif kind == "del":
            draft.pop()
        else:
            draft.append(LUT[rng.integers(0, 4)])
        prev = pos
    draft += genome_b[prev:]
    draft = bytes(draft)

    read_len = 250
    n_reads = n * coverage // read_len
    asm = os.path.join(RACE, "asm.fa")
    reads = os.path.join(RACE, "reads.fq")
    with open(asm, "wb") as f:
        f.write(b">ctg1\n")
        for off in range(0, len(draft), 70):
            f.write(draft[off : off + 70] + b"\n")

    # hotspot errors: n/30 positions, per-hotspot probability skewed small
    n_hot = n // 30
    hot_pos = np.sort(rng.integers(0, n, size=n_hot))
    hot_base = ((gcodes[hot_pos] + rng.integers(1, 4, size=n_hot)) % 4).astype(np.uint8)
    hot_prob = rng.uniform(0.005, 0.18, size=n_hot) ** 1.5

    RC = np.zeros(256, np.uint8)
    for a, b in zip(b"ACGT", b"TGCA"):
        RC[a] = b
    starts = rng.integers(0, n - read_len, size=n_reads)
    qual = b"I" * read_len
    garr = np.frombuffer(genome_b, np.uint8)
    rl_idx = np.arange(read_len)
    CHUNK = 16384  # reads per batch
    with open(reads, "wb") as f:
        for c0 in range(0, n_reads, CHUNK):
            ss = starts[c0 : c0 + CHUNK]
            m = len(ss)
            mat = garr[ss[:, None] + rl_idx[None, :]]
            # hotspot application (vectorized per batch)
            lo = np.searchsorted(hot_pos, ss)
            hi = np.searchsorted(hot_pos, ss + read_len)
            for j in range(m):
                if hi[j] > lo[j]:
                    seg = slice(lo[j], hi[j])
                    hit = rng.random(hi[j] - lo[j]) < hot_prob[seg]
                    cols = hot_pos[seg][hit] - ss[j]
                    mat[j, cols] = LUT[hot_base[seg][hit]]
            # random 0.2% errors
            emask = rng.random(mat.shape) < 0.002
            repl = LUT[rng.integers(0, 4, size=mat.shape).astype(np.uint8)]
            mat = np.where(emask, repl, mat)
            # revcomp odd reads
            odd = (np.arange(c0, c0 + m) % 2) == 1
            mat[odd] = RC[mat[odd][:, ::-1]]
            parts = []
            for j in range(m):
                parts.append(b"@r%d\n" % (c0 + j))
                parts.append(mat[j].tobytes())
                parts.append(b"\n+\n")
                parts.append(qual)
                parts.append(b"\n")
            f.write(b"".join(parts))
    return asm, reads


def setup_pyenv():
    """One dir serving jasper.sh's single-path $PYTHONPATH contract:
    jellyfish.py (threshold script) + real dna_jellyfish + Bio shim."""
    pyenv = os.path.join(RACE, "pyenv")
    os.makedirs(pyenv, exist_ok=True)
    for src in (
        os.path.join(BASE, "jasper/src/jellyfish.py"),
        os.path.join(BASE, "pysite/dna_jellyfish.py"),
        os.path.join(BASE, "pysite/_dna_jellyfish.so"),
    ):
        shutil.copy(src, pyenv)
    shutil.copytree(
        os.path.join(REPO, "tests/oracle/Bio"),
        os.path.join(pyenv, "Bio"),
        dirs_exist_ok=True,
    )
    # this image ships no `bc`; jasper.sh's QV math needs one (sh:238-256)
    bindir = os.path.join(RACE, "bin")
    os.makedirs(bindir, exist_ok=True)
    bc = os.path.join(bindir, "bc")
    with open(bc, "w") as f:
        f.write("#!/bin/sh\nexec %s %s \"$@\"\n"
                % (sys.executable, os.path.join(REPO, "tools/bc_shim.py")))
    os.chmod(bc, 0o755)
    return pyenv


def run_reference(asm, reads, k, passes, threads, batch, run_id=""):
    wd = os.path.join(RACE, "ref" + run_id)
    os.makedirs(wd, exist_ok=True)
    pyenv = setup_pyenv()
    env = dict(os.environ)
    env["PATH"] = (os.path.join(BASE, "install/bin") + os.pathsep
                   + os.path.join(RACE, "bin") + os.pathsep + env["PATH"])
    env["PYTHONPATH"] = pyenv
    env["JASPER_TPU_ROOT"] = REPO
    t0 = time.time()
    r = subprocess.run(
        ["bash", os.path.join(BASE, "jasper/src/jasper.sh"),
         "-a", asm, "-r", reads, "-k", str(k), "-p", str(passes),
         "-t", str(threads), "-b", str(batch)],
        cwd=wd, env=env, capture_output=True, text=True,
    )
    dt = time.time() - t0
    if r.returncode != 0:
        log("reference FAILED:\n" + r.stdout[-3000:] + r.stderr[-3000:])
        raise SystemExit(1)
    log(f"reference done in {dt:.1f}s")
    return wd, dt, r.stdout


def run_ours(asm, reads, k, passes, threads, batch, platform=None, run_id=""):
    """Fresh-process CLI run, exactly how a user invokes it. A second run
    is "warm": the persistent compilation cache (driver.py:386-388) holds
    every program, so only table/count work executes."""
    wd = os.path.join(RACE, "ours" + run_id)
    os.makedirs(wd, exist_ok=True)
    env = dict(os.environ)
    if platform:
        env["JAX_PLATFORMS"] = platform
    t0 = time.time()
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "bin", "jasper-tpu"),
         "-a", asm, "-r", reads, "-k", str(k), "-p", str(passes),
         "-t", str(threads), "-b", str(batch)],
        cwd=wd, env=env, capture_output=True, text=True,
    )
    dt = time.time() - t0
    if r.returncode != 0:
        log("jasper-tpu FAILED:\n" + r.stdout[-3000:] + r.stderr[-3000:])
        raise SystemExit(1)
    log(f"jasper-tpu done in {dt:.1f}s")
    qv = re.findall(r"Q value = ([0-9.]+|Inf)", r.stdout + r.stderr)
    return wd, dt, {"q_before": qv[0] if qv else "",
                    "q_after": qv[1] if len(qv) > 1 else ""}


def main():
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    keep = "--keep" in sys.argv
    runs = 1
    ref_runs = None
    for a in sys.argv[1:]:
        if a.startswith("--runs="):
            runs = int(a.split("=", 1)[1])
        if a.startswith("--ref-runs="):
            # at chromosome scale the reference's warm/cold delta is page
            # cache only; let the caller skip its repeat runs
            ref_runs = int(a.split("=", 1)[1])
    if ref_runs is None:
        ref_runs = runs
    genome_kb = int(args[0]) if len(args) > 0 else 2000
    coverage = int(args[1]) if len(args) > 1 else 40
    k = int(args[2]) if len(args) > 2 else 25
    passes = int(args[3]) if len(args) > 3 else 2
    threads = int(args[4]) if len(args) > 4 else 16
    batch = 25_000_000  # one batch both sides: identical boundary quirk

    if not os.path.exists(os.path.join(BASE, "install/bin/jellyfish")):
        log("run tools/build_baseline.sh first")
        raise SystemExit(2)
    if os.path.exists(RACE) and not keep:
        shutil.rmtree(RACE)
    os.makedirs(RACE, exist_ok=True)
    data_marker = os.path.join(RACE, f"data.{genome_kb}.{coverage}.ok")
    if keep and os.path.exists(data_marker):
        asm = os.path.join(RACE, "asm.fa")
        reads = os.path.join(RACE, "reads.fq")
        log("reusing kept input data")
    else:
        log(f"generating {genome_kb} kb genome at {coverage}x")
        asm, reads = make_data(genome_kb, coverage)
        with open(data_marker, "w") as f:
            f.write("ok\n")

    # run N times each, fresh workdirs: run 1 is cold (reference: cold page
    # cache; ours: first-ever compiles unless the persistent cache is
    # already populated), later runs are warm
    ref_times, ours_times = [], []
    for i in range(ref_runs):
        rid = "" if ref_runs == 1 else f"_run{i + 1}"
        ref_wd, ref_s, ref_out = run_reference(
            asm, reads, k, passes, threads, batch, run_id=rid)
        ref_times.append(round(ref_s, 1))
    for i in range(runs):
        rid = "" if runs == 1 else f"_run{i + 1}"
        ours_wd, ours_s, ours_res = run_ours(
            asm, reads, k, passes, 1, batch, run_id=rid)
        ours_times.append(round(ours_s, 1))

    def slurp(d, name):
        with open(os.path.join(d, name), "rb") as f:
            return f.read()

    pol_ref = slurp(ref_wd, "asm.fa.polished.fasta")
    pol_ours = slurp(ours_wd, "asm.fa.polished.fasta")
    fix_ref = slurp(ref_wd, "asm.fa.fixes.csv")
    fix_ours = slurp(ours_wd, "asm.fa.fixes.csv")
    import re

    qv_ref = re.findall(rb"Q value = ([0-9.]+|Inf)", ref_out.encode())
    result = {
        "genome_kb": genome_kb, "coverage": coverage, "k": k,
        "passes": passes, "ref_threads": threads,
        "ref_secs": round(ref_s, 1), "ours_secs": round(ours_s, 1),
        "ref_secs_runs": ref_times, "ours_secs_runs": ours_times,
        "speedup": round(ref_s / ours_s, 2),
        "polished_identical": pol_ref == pol_ours,
        "fixes_identical": fix_ref == fix_ours,
        "ref_qv": [q.decode() for q in qv_ref],
        "ours_qv": [ours_res["q_before"], ours_res["q_after"]],
    }
    print(json.dumps(result))
    if not (result["polished_identical"] and result["fixes_identical"]):
        log("PARITY FAILURE — outputs differ")
        raise SystemExit(1)


if __name__ == "__main__":
    main()
