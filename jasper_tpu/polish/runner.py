"""Multi-pass polishing driver — file-level parity with reference jasper.py.

Reproduces the reference main/iteration orchestration (src/jasper.py:12-137)
byte-for-byte:

  * passes p fixing iterations + 1 final QV-only scan,
  * per-iteration fix CSV named by the reference's os.path.split mangling
    (head + "_iter{ite}_" + tail, j.py:48-49) — written with csv.writer
    delimiter=' ' and its default CRLF line terminator,
  * the CSV header labels 'Original','Mutation' with data columns actually
    ordered (mutation, original) — a reference quirk kept as-is
    (j.py:115 vs j.py:219),
  * '{ite}qValCalcHelper.csv' appended with "wrong total" on the first and
    last iteration when test=True (j.py:107-111),
  * 60-column fixed FASTA written on the final iteration when fixing was
    requested (j.py:120-128).
"""

from __future__ import annotations

import csv
import os

from jasper_tpu.io.fastx import read_fasta
from jasper_tpu.polish.engine import CountSource, PolishEngine


def _iter_name(path: str, ite: int) -> str:
    head, tail = os.path.split(path)
    return head + "_iter" + str(ite) + "_" + tail


def polish_file(
    query_path: str,
    counts: CountSource,
    k: int,
    threshold: int,
    passes: int,
    fix: bool = True,
    test: bool = True,
    fout: str = "fout.csv",
    fixedout: str = "fixed_seq.fasta",
    workdir: str = ".",
    seqs: dict[str, str] | None = None,
    engine_cls=PolishEngine,
):
    """Run `passes` fixing iterations + one QV scan over a FASTA file.

    Writes the same artifact set as reference jasper.py. Returns the final
    sequence dict.
    """
    import time as _time

    engine = engine_cls(counts, k, threshold)
    user_fix_choice = fix
    if seqs is None:
        seqs = read_fasta(query_path)
    final_fixedout = fixedout
    for ite in range(passes + 1):
        ite_fix = fix
        if ite == passes:
            ite_fix = False
            final_fixedout = _iter_name(fixedout, ite - 1)
        _t0 = _time.perf_counter()
        result = engine.run_pass(seqs, ite_fix)
        print(f"[stage] polish pass {ite} scan+fix "
              f"{_time.perf_counter() - _t0:.1f}s", flush=True)
        seqs = result.seqs

        if test and (ite == 0 or ite == passes):
            helper = os.path.join(workdir, f"{ite}qValCalcHelper.csv")
            with open(helper, "a") as f:
                f.write(f"{result.total_wrong_kmers} {result.total_kmers}\n")

        if ite_fix:
            ite_fout = os.path.join(workdir, _iter_name(fout, ite))
            with open(ite_fout, "w") as f:
                w = csv.writer(f, delimiter=" ")
                w.writerow(["Contig", "Base_coord", "Original", "Mutation"])
                w.writerows(
                    [r.contig, r.coord, r.mutation, r.original] for r in result.fixes
                )

        if ite == passes and user_fix_choice:
            out_path = os.path.join(workdir, final_fixedout)
            with open(out_path, "w") as f:
                for name, seq in seqs.items():
                    f.write(f">{name}\n")
                    for off in range(0, len(seq), 60):
                        f.write(seq[off : off + 60] + "\n")
    return seqs


def main(argv=None) -> int:
    """CLI with the reference jasper.py's exact flags (src/jasper.py:634-647).

    jasper.sh-generated run_jasper.sh scripts work verbatim against this
    entry point:  python -m jasper_tpu.polish.runner --db db.jf -q batch.fa
    --ksize 37 -p 2 --fix --fout f.csv -ff fixed.fa --test -thre 5
    """
    import argparse
    import sys

    parser = argparse.ArgumentParser()
    parser.add_argument("--db", default=None,
                        help="The path to the .jf database file.")
    parser.add_argument("--reads", nargs="+", default=None,
                        help="Accepted for reference-CLI parity (the reference "
                             "requires --db too; build DBs with jellyfish-tpu count)")
    parser.add_argument("-q", "--query", help="The path to the .fasta query file")
    parser.add_argument("-thre", "--threshold", type=int, default=None,
                        help="The threshold for an unreliable kmer.")
    parser.add_argument("-k", "--ksize", type=int, help="The kmer size")
    parser.add_argument("--test", action="store_true",
                        help="Output the total num of bad kmers and a Q estimate")
    parser.add_argument("--fix", action="store_true",
                        help="Output fixed-base indices and the new sequence")
    parser.add_argument("--fout", default="fout.csv",
                        help="The path to output the index of the fixed bases.")
    parser.add_argument("-ff", "--fixedfasta", default="fixed_seq.fasta",
                        help="The path to output the fixed assembly sequences")
    parser.add_argument("-p", "--passes", type=int, default=2,
                        help="The number of iterations of fixing.")
    parser.add_argument("--table-npy", default=None,
                        help="Load the count table from a .npy memmap instead "
                             "of --db: zero-copy page-cache sharing across "
                             "worker processes (the analog of the reference's "
                             "shared .jf mmap, src/jasper.sh:209-211). "
                             "Requires --ksize.")
    args = parser.parse_args(argv)

    try:
        import numpy as np

        from jasper_tpu.polish.engine import CountSource

        if args.table_npy:
            from jasper_tpu.table.host_table import HostKmerTable

            host_table = HostKmerTable(
                args.ksize, np.load(args.table_npy, mmap_mode="r")
            )
        else:
            from jasper_tpu.io.jf import load_jf_into_host_table

            host_table, _ = load_jf_into_host_table(args.db)
        polish_file(
            args.query,
            CountSource(host_table),
            args.ksize if args.ksize else host_table.k,
            args.threshold,
            args.passes,
            fix=args.fix,
            test=args.test,
            fout=args.fout,
            fixedout=args.fixedfasta,
        )
    except Exception:
        # reference behavior: any failure prints the line + info, exit 1
        # (src/jasper.py:27-32)
        import traceback

        tb = sys.exc_info()[2]
        while tb.tb_next:
            tb = tb.tb_next
        print(tb.tb_lineno)
        print(sys.exc_info())
        traceback.print_exc(file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
