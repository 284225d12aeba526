"""The port's ``csr-tool`` and ``suitesparse-dl`` against the JAX package's:
the same text on stdout (``gen``'s scripts differ only in the module they run),
the same bin2 bytes from ``conv``, and ``dl --dry-run`` over a local CSV,
offline.  ``fetch`` and ``dl`` without ``--dry-run`` need the network and are
not run."""

import csv
import os
import tarfile

import numpy as np
import pytest

from spmv_acc_tpu.cli import csr_tool as ref_csr_tool
from spmv_acc_tpu.cli import suitesparse_dl as ref_dl
from spmv_acc_tpu.formats.generate import example_like, random_x_y
from spmv_acc_tpu.io import write_bin2, write_csr_text, write_mtx
from spmv_acc_tpu_torch.cli import csr_tool, suitesparse_dl


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """rajat03 as bin2, csr text and mtx, in one directory."""
    d = tmp_path_factory.mktemp("matrices")
    rp, ci, v, shape = example_like("rajat03").to_numpy()
    rp, ci, v = (np.asarray(a) for a in (rp, ci, v))
    write_bin2(str(d / "rajat03.bin2"), rp, ci, v, shape)
    write_csr_text(str(d / "rajat03.csr"), rp, ci, v, random_x_y(shape[1], shape[0], seed=1)[0])
    rows = np.repeat(np.arange(shape[0]), np.diff(rp))
    write_mtx(str(d / "rajat03.mtx"), rows, ci, v, shape)
    return d


def _run(main, argv, capsys):
    rc = main(argv)
    return rc, capsys.readouterr().out


@pytest.mark.parametrize("fmt", ["bin2", "csr", "mtx"])
@pytest.mark.parametrize("parts", [1, 4, 7])
def test_csr_tool_nnz_prints_the_reference_text(files, capsys, fmt, parts):
    argv = ["nnz", "-i", str(files / f"rajat03.{fmt}"), "-p", str(parts), "-f", fmt]
    got, want = _run(csr_tool.main, argv, capsys), _run(ref_csr_tool.main, argv, capsys)
    assert got == want and got[0] == 0 and got[1].count("\n") == parts + 2


@pytest.mark.parametrize("fmt", ["bin2", "csr", "mtx"])
def test_csr_tool_dist_prints_the_reference_text(files, capsys, fmt):
    argv = ["dist", "-i", str(files / f"rajat03.{fmt}")]
    got, want = _run(csr_tool.main, argv, capsys), _run(ref_csr_tool.main, argv, capsys)
    assert got == want and got[0] == 0 and got[1].startswith("matrix: rows=")


def test_conv_mtx_writes_the_reference_bin2(files, tmp_path, capsys):
    src = str(files / "rajat03.mtx")
    ours, theirs = str(tmp_path / "ours.bin2"), str(tmp_path / "theirs.bin2")
    rc, out = _run(suitesparse_dl.main, ["conv", src, "-o", ours], capsys)
    rc_ref, out_ref = _run(ref_dl.main, ["conv", src, "-o", theirs], capsys)
    assert rc == rc_ref == 0 and out.replace(ours, "X") == out_ref.replace(theirs, "X")
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()


def test_conv_tar_gz_writes_the_reference_bin2(files, tmp_path, capsys):
    outs = []
    for name, main in (("ours", suitesparse_dl.main), ("theirs", ref_dl.main)):
        d = tmp_path / name
        d.mkdir()
        tgz = d / "rajat03.tar.gz"
        with tarfile.open(tgz, "w:gz") as tf:
            tf.add(str(files / "rajat03.mtx"), arcname="rajat03/rajat03.mtx")
        rc, out = _run(main, ["conv", str(tgz)], capsys)
        path = d / "rajat03" / "rajat03.bin2"
        assert rc == 0 and out.startswith(f"wrote {path}: rows=")
        outs.append(path.read_bytes())
    assert outs[0] == outs[1]


def test_list_prints_the_reference_text(files, capsys):
    got, want = (_run(m, ["list", str(files)], capsys) for m in (suitesparse_dl.main, ref_dl.main))
    assert got == want and got[1].count("\n") == 4


def test_gen_differs_only_in_the_module(files, tmp_path, capsys):
    ours, theirs = tmp_path / "ours", tmp_path / "theirs"
    rc, out = _run(suitesparse_dl.main, ["gen", str(files), "-o", str(ours)], capsys)
    rc_ref, out_ref = _run(ref_dl.main, ["gen", str(files), "-o", str(theirs)], capsys)
    assert rc == rc_ref == 0 and out.replace(str(ours), "X") == out_ref.replace(str(theirs), "X")
    names = sorted(os.listdir(ours))
    assert names == sorted(os.listdir(theirs)) and len(names) == 1  # one job name, rajat03
    script = (ours / names[0]).read_text()
    assert "python -m spmv_acc_tpu_torch.cli.main " in script
    assert script.replace("spmv_acc_tpu_torch.cli.main", "spmv_acc_tpu.cli.main") == (
        theirs / names[0]).read_text()


def test_dl_dry_run_is_offline(tmp_path, capsys, monkeypatch):
    import urllib.request

    def no_network(*args, **kwargs):
        raise AssertionError("dl --dry-run reached for the network")

    monkeypatch.setattr(urllib.request, "urlretrieve", no_network)
    monkeypatch.setattr(urllib.request, "urlopen", no_network)
    table = tmp_path / "index.csv"
    with open(table, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["group", "name", "rows", "cols", "nnz", "bucket"])
        w.writerow(["HB", "bcsstk01", "48", "48", "400", "1k"])
        w.writerow(["Rajat", "rajat03", "7602", "7602", "32653", "100k"])
        w.writerow(["GHS_psdef", "ldoor", "952203", "952203", "42493817", "100M"])
    outs = []
    for name, main in (("ours", suitesparse_dl.main), ("theirs", ref_dl.main)):
        d = tmp_path / name
        rc, out = _run(main, ["dl", "--csv", str(table), "-o", str(d), "--dry-run",
                              "--bucket", "100k"], capsys)
        assert rc == 0 and sorted(os.listdir(d)) == ["100k"]
        outs.append(out.replace(str(d), "X"))
    assert outs[0] == outs[1] and outs[0].count("downloading ") == 1 and "rajat03" in outs[0]


def test_bucket_of_agrees():
    for nnz in [0, 1, 999, 1000, 9_999, 10_000, 123_456, 10**6, 10**8, 10**9, 10**10, 10**11]:
        assert suitesparse_dl.bucket_of(nnz) == ref_dl.bucket_of(nnz)
