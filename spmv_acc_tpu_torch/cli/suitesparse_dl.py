"""suitesparse-dl equivalent (reference tools/suitesparse-dl, Go): fetch / dl /
list / conv / gen subcommands (cli.go:1-27), the JAX package's
``cli/suitesparse_dl.py`` on the port's readers and writers.  The scripts ``gen``
writes run the port's ``spmv-cli``.

Network-dependent subcommands (fetch/dl) degrade gracefully in zero-egress
environments: they print what they *would* download and exit non-zero on network
failure, so the offline workflow (list/conv/gen) always works.
"""

from __future__ import annotations

import argparse
import csv as _csv
import os
import sys
import tarfile

SUITESPARSE_INDEX_URL = "https://sparse.tamu.edu/files/ssstats.csv"
SUITESPARSE_MAT_URL = "https://suitesparse-collection-website.herokuapp.com/MM/{group}/{name}.tar.gz"

# Size buckets matching the reference's dl layout (dl/dl.go): 1k..10G by nnz
BUCKETS = [
    ("1k", 0, 1_000),
    ("10k", 1_000, 10_000),
    ("100k", 10_000, 100_000),
    ("1M", 100_000, 1_000_000),
    ("10M", 1_000_000, 10_000_000),
    ("100M", 10_000_000, 100_000_000),
    ("1G", 100_000_000, 1_000_000_000),
    ("10G", 1_000_000_000, 10_000_000_000),
]


def bucket_of(nnz: int) -> str:
    for name, lo, hi in BUCKETS:
        if lo <= nnz < hi:
            return name
    return BUCKETS[-1][0]


def cmd_fetch(args) -> int:
    """Scrape the SuiteSparse index to CSV (fetch/fetch.go analog)."""
    try:
        from urllib.request import urlopen

        with urlopen(SUITESPARSE_INDEX_URL, timeout=30) as resp:
            data = resp.read().decode()
    except Exception as e:
        print(f"fetch failed (offline environment?): {e}", file=sys.stderr)
        return 1
    lines = data.strip().split("\n")
    # ssstats.csv: first two lines are counts/date, then group,name,rows,cols,nnz,...
    out = args.output
    with open(out, "w", newline="") as f:
        w = _csv.writer(f)
        w.writerow(["group", "name", "rows", "cols", "nnz", "bucket"])
        for ln in lines[2:]:
            parts = ln.split(",")
            if len(parts) < 5:
                continue
            group, name, rows, cols, nnz = parts[0], parts[1], parts[2], parts[3], parts[4]
            w.writerow([group, name, rows, cols, nnz, bucket_of(int(nnz))])
    print(f"wrote {out}")
    return 0


def cmd_dl(args) -> int:
    """Download matrices from a fetched CSV into size-bucket directories."""
    try:
        from urllib.request import urlretrieve
    except Exception as e:  # pragma: no cover
        print(f"dl unavailable: {e}", file=sys.stderr)
        return 1
    failures = 0
    with open(args.csv) as f:
        rd = _csv.DictReader(f)
        for row in rd:
            if args.bucket and row["bucket"] != args.bucket:
                continue
            url = SUITESPARSE_MAT_URL.format(group=row["group"], name=row["name"])
            dest_dir = os.path.join(args.output, row["bucket"])
            os.makedirs(dest_dir, exist_ok=True)
            dest = os.path.join(dest_dir, f"{row['name']}.tar.gz")
            if os.path.exists(dest):
                continue
            print(f"downloading {url} -> {dest}")
            if args.dry_run:
                continue
            try:
                urlretrieve(url, dest)
            except Exception as e:
                print(f"  failed: {e}", file=sys.stderr)
                failures += 1
    return 1 if failures else 0


def cmd_list(args) -> int:
    """CSV a directory of matrix files (list analog)."""
    rows = []
    for root, _, files in os.walk(args.dir):
        for fn in sorted(files):
            if fn.endswith((".mtx", ".csr", ".bin2", ".tar.gz")):
                p = os.path.join(root, fn)
                rows.append((p, os.path.getsize(p)))
    print("path,bytes")
    for p, s in rows:
        print(f"{p},{s}")
    return 0


def cmd_conv(args) -> int:
    """Convert .mtx (possibly inside .tar.gz) → bin2 (conv/conv.go analog)."""
    from ..formats.convert import coo_to_csr_arrays
    from ..io.binary import write_bin2
    from ..io.matrix_market import read_mtx

    src = args.input
    work = src
    if src.endswith(".tar.gz"):
        with tarfile.open(src) as tf:
            members = [m for m in tf.getmembers() if m.name.endswith(".mtx")]
            if not members:
                print(f"no .mtx inside {src}", file=sys.stderr)
                return 1
            # "data": no member may land outside the directory or carry its metadata
            tf.extract(members[0], path=os.path.dirname(src) or ".", filter="data")
            work = os.path.join(os.path.dirname(src) or ".", members[0].name)
    r, c, v, shape = read_mtx(work)
    rp, ci, vv = coo_to_csr_arrays(r, c, v, shape)
    out = args.output or os.path.splitext(work)[0] + ".bin2"
    write_bin2(out, rp, ci, vv, shape)
    print(f"wrote {out}: rows={shape[0]} cols={shape[1]} nnz={len(vv)}")
    return 0


SBATCH_TEMPLATE = """#!/bin/bash
#SBATCH --job-name={job}
#SBATCH --partition={partition}
#SBATCH --ntasks=1
#SBATCH --output={job}.%j.out

{cmd}
"""


def cmd_gen(args) -> int:
    """Render batch scripts from a template (batch-gen/gen.go analog)."""
    os.makedirs(args.output, exist_ok=True)
    count = 0
    for root, _, files in os.walk(args.dir):
        for fn in sorted(files):
            if not fn.endswith((".csr", ".bin2", ".mtx")):
                continue
            path = os.path.join(root, fn)
            job = os.path.splitext(fn)[0]
            fmt = {"csr": "csr", "bin2": "bin2", "mtx": "mtx"}[fn.rsplit(".", 1)[1]]
            cmd = f"python -m spmv_acc_tpu_torch.cli.main {path} -f {fmt}"
            script = SBATCH_TEMPLATE.format(job=job, partition=args.partition, cmd=cmd)
            out = os.path.join(args.output, f"{job}.sh")
            with open(out, "w") as f:
                f.write(script)
            count += 1
    print(f"generated {count} scripts in {args.output}")
    return 0


def build_parser():
    p = argparse.ArgumentParser(prog="suitesparse-dl")
    sub = p.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("fetch")
    sp.add_argument("-o", "--output", default="suitesparse.csv")
    sp.set_defaults(fn=cmd_fetch)

    sp = sub.add_parser("dl")
    sp.add_argument("--csv", required=True)
    sp.add_argument("-o", "--output", default="matrices")
    sp.add_argument("--bucket", default=None)
    sp.add_argument("--dry-run", action="store_true")
    sp.set_defaults(fn=cmd_dl)

    sp = sub.add_parser("list")
    sp.add_argument("dir")
    sp.set_defaults(fn=cmd_list)

    sp = sub.add_parser("conv")
    sp.add_argument("input")
    sp.add_argument("-o", "--output", default=None)
    sp.set_defaults(fn=cmd_conv)

    sp = sub.add_parser("gen")
    sp.add_argument("dir")
    sp.add_argument("-o", "--output", default="batch")
    sp.add_argument("--partition", default="normal")
    sp.set_defaults(fn=cmd_gen)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
