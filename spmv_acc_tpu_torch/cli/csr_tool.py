"""csr-tool equivalent: offline matrix analyzer (reference tools/main.cpp:54-182),
the JAX package's ``cli/csr_tool.py`` on the port's readers, with the same text.

Subcommands:
  * ``nnz -i FILE -p PARTS`` — split rows into PARTS contiguous parts; print per-part
    nnz and avg nnz/row (tools/main.cpp:117-150).
  * ``dist -i FILE``         — row-length histogram (tools/main.cpp:152-182).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ..io import load_matrix


def cmd_nnz(args) -> int:
    row_ptr, _, values, (m, n), _ = load_matrix(args.input, fmt=args.format)
    parts = args.parts
    cuts = np.linspace(0, m, parts + 1).astype(np.int64)
    print(f"matrix: rows={m} cols={n} nnz={len(values)}")
    print("part,rows,nnz,avg_nnz_per_row")
    for k in range(parts):
        r0, r1 = int(cuts[k]), int(cuts[k + 1])
        part_nnz = int(row_ptr[r1] - row_ptr[r0])
        rows = max(r1 - r0, 1)
        print(f"{k},{r1 - r0},{part_nnz},{part_nnz / rows:.3f}")
    return 0


def cmd_dist(args) -> int:
    row_ptr, _, values, (m, n), _ = load_matrix(args.input, fmt=args.format)
    lens = np.diff(np.asarray(row_ptr))
    print(f"matrix: rows={m} cols={n} nnz={len(values)}")
    print("row_length,count")
    for length, count in zip(*np.unique(lens, return_counts=True)):
        print(f"{int(length)},{int(count)}")
    return 0


def build_parser():
    p = argparse.ArgumentParser(prog="csr-tool", description="sparse matrix analyzer")
    sub = p.add_subparsers(dest="cmd", required=True)
    for name, fn in (("nnz", cmd_nnz), ("dist", cmd_dist)):
        sp = sub.add_parser(name)
        sp.add_argument("-i", "--input", required=True)
        sp.add_argument("-f", "--format", default=None, choices=[None, "csr", "mtx", "bin2"])
        if name == "nnz":
            sp.add_argument("-p", "--parts", type=int, default=4)
        sp.set_defaults(fn=fn)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
