"""Matrix Market (.mtx) coordinate reader/writer.

Behavior matches the reference reader (cli/matrix_market_reader.hpp:48-303, itself
derived from holaspmv's COO.cpp): header ``%%MatrixMarket matrix coordinate
<field> <symmetry>``; real/integer/pattern fields (pattern → value 1.0); symmetric /
hermitian / skew-symmetric matrices are mirrored across the diagonal (off-diagonal
entries duplicated with swapped indices, hermitian treated as real); 1-based indices
converted to 0-based; indices validated against the header dimensions.

The hot path is vectorised numpy text parsing (the analog of the reference's OpenMP
per-line parse, matrix_market_reader.hpp:90-115); the same code as the JAX
package's ``spmv_acc_tpu/io/matrix_market.py``.
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np

__all__ = ["MMHeader", "read_mtx", "write_mtx"]


@dataclasses.dataclass
class MMHeader:
    """Parsed header (reference mm_header, cli/sparse_format.h:29-60)."""

    rows: int
    cols: int
    nnz_declared: int
    field: str  # real | integer | pattern | complex
    symmetry: str  # general | symmetric | skew-symmetric | hermitian

    @property
    def pattern(self) -> bool:
        return self.field == "pattern"

    @property
    def mirrored(self) -> bool:
        return self.symmetry in ("symmetric", "hermitian", "skew-symmetric")


def _parse_header(lines, path):
    first = lines[0].strip().split()
    if len(first) < 5 or first[0] not in ("%%MatrixMarket", "%MatrixMarket"):
        raise ValueError(f"invalid MatrixMarket banner in {path!r}: {lines[0]!r}")
    _, obj, fmt, field, symmetry = first[:5]
    if obj.lower() != "matrix" or fmt.lower() != "coordinate":
        raise ValueError(
            f"only 'matrix coordinate' supported (got {obj} {fmt}) in {path!r}"
        )
    field = field.lower()
    symmetry = symmetry.lower()
    if field not in ("real", "integer", "pattern", "complex", "double"):
        raise ValueError(f"unsupported field {field!r} in {path!r}")
    i = 1
    while i < len(lines) and (not lines[i].strip() or lines[i].lstrip().startswith("%")):
        i += 1
    if i >= len(lines):
        raise ValueError(f"missing size line in {path!r}")
    dims = lines[i].split()
    rows, cols, nnz = int(dims[0]), int(dims[1]), int(dims[2])
    return MMHeader(rows, cols, nnz, "real" if field == "double" else field, symmetry), i + 1


def read_mtx(path, dtype=np.float64):
    """Returns (coo_rows, coo_cols, values, shape) with symmetry expanded.

    The mirrored entry count follows the reference's accounting
    (matrix_market_reader.hpp:288-299): every off-diagonal entry of a
    symmetric/hermitian matrix appears twice; skew-symmetric mirrors with negation.
    """
    with open(path, "r") as f:
        text = f.read()
    lines = text.split("\n")
    header, body_start = _parse_header(lines, path)

    body_lines = [
        ln for ln in lines[body_start:] if ln.strip() and not ln.lstrip().startswith("%")
    ]
    ncols_file = 2 if header.pattern else (4 if header.field == "complex" else 3)
    body = " ".join(body_lines)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        flat = np.fromstring(body, dtype=np.float64, sep=" ")
    if flat.size != len(body_lines) * ncols_file:
        # Fall back to tolerant per-line parse (ragged / malformed whitespace)
        flat = np.array(body.split(), dtype=np.float64)
        if flat.size % ncols_file != 0:
            raise ValueError(f"malformed body in {path!r}")
    table = flat.reshape(-1, ncols_file)
    if table.shape[0] != header.nnz_declared:
        raise ValueError(
            f"mismatch non-zeros number, expect {header.nnz_declared}, "
            f"but got {table.shape[0]}"
        )
    r = table[:, 0].astype(np.int64) - 1
    c = table[:, 1].astype(np.int64) - 1
    if (r < 0).any() or (r >= header.rows).any():
        raise ValueError(f"Row index out of bounds in matrix market file {path!r}")
    if (c < 0).any() or (c >= header.cols).any():
        raise ValueError(f"Column index out of bounds in matrix market file {path!r}")
    if header.pattern:
        v = np.ones(len(r), dtype=dtype)
    else:
        v = table[:, 2].astype(dtype)  # complex: real part (reference is double-only)

    if header.mirrored:
        off = r != c
        sign = -1.0 if header.symmetry == "skew-symmetric" else 1.0
        r = np.concatenate([r, c[off]])
        c2 = np.concatenate([c, table[:, 0].astype(np.int64)[off] - 1])
        v = np.concatenate([v, sign * v[off]])
        c = c2
    return r.astype(np.int32), c.astype(np.int32), v, (header.rows, header.cols)


def write_mtx(path, rows, cols, values, shape, symmetry="general", field="real"):
    rows = np.asarray(rows)
    cols = np.asarray(cols)
    values = np.asarray(values)
    with open(path, "w") as f:
        f.write(f"%%MatrixMarket matrix coordinate {field} {symmetry}\n")
        f.write(f"{shape[0]} {shape[1]} {len(values)}\n")
        if field == "pattern":
            for r, c in zip(rows, cols):
                f.write(f"{int(r) + 1} {int(c) + 1}\n")
        else:
            for r, c, v in zip(rows, cols, values):
                f.write(f"{int(r) + 1} {int(c) + 1} {float(v)!r}\n")
