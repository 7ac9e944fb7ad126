"""The port's eval CLI (`--device cpu`) against the JAX eval CLI, called
in-process on the same synthetic test split and fused dumps: three pairs in
two shapes (two shape groups), one unpaired visible image (the pairing
filter) and one pair without a fused result (the skip message). Both
workbook layouts, with two method names that share one fused-image folder
(evaluated once). The workbooks must have the same sheets, the same cell
grid and the same labels; numbers agree within the metric budget (1e-4
relative and absolute, VIFF 1e-3, docs/PARITY.md).

Also: per-image values do not depend on the chunking of a shape group,
`--spatial > 1` raises, and without a card the CLI does not fall back to
the CPU unless asked.
"""

import os
import re
import shutil
import zipfile

import numpy as np
import pytest

from multi_modal_image_fusion_tpu.cli import eval as jax_eval_cli
from multi_modal_image_fusion_tpu_torch.cli import eval as eval_cli
from multi_modal_image_fusion_tpu_torch.data.io import imwrite
from multi_modal_image_fusion_tpu_torch.utils.xlsx import Workbook

_CELL = re.compile(r'<c r="([A-Z]+)(\d+)"(?: t="inlineStr")?>'
                   r'(?:<v>([^<]*)</v>|<is><t>([^<]*)</t></is>)</c>')
_SHEET = re.compile(r'<sheet name="([^"]*)"')


@pytest.fixture(scope="module")
def dump(tmp_path_factory):
    """<root>/datasets/tinyset/test/{vis,ir} and the fused NN.bmp files
    under <root>/{jax,port}/run/tinyset/."""
    root = tmp_path_factory.mktemp("torch_eval")
    data = root / "datasets" / "tinyset" / "test"
    for mod in ("vis", "ir"):
        os.makedirs(data / mod)
    fused = root / "fused"
    os.makedirs(fused)
    r = np.random.RandomState(0)
    shapes = [(48, 56), (41, 37), (48, 56), (30, 30)]
    for i, (h, w) in enumerate(shapes):
        yy, xx = np.mgrid[0:h, 0:w]
        base = 127 + 90 * np.sin(xx / (5.0 + i)) * np.cos(yy / 7.0)
        vis = np.clip(base + r.randn(h, w) * 10, 0, 255).astype(np.uint8)
        ir = np.clip(255 - base * 0.6 + r.randn(h, w) * 20, 0,
                     255).astype(np.uint8)
        imwrite(str(data / "vis" / f"{i + 1}.png"), vis)
        imwrite(str(data / "ir" / f"{i + 1}.png"), ir)
        if i < 3:                      # pair 4 has no fused result
            f = np.clip(0.5 * vis + 0.5 * ir + r.randn(h, w) * 4, 0, 255)
            imwrite(str(fused / f"{i + 1:0>2}.bmp"), f.astype(np.uint8))
    imwrite(str(data / "vis" / "0_unpaired.png"),
            np.zeros((20, 20), np.uint8))
    for side in ("jax", "port"):
        shutil.copytree(fused, root / side / "run" / "tinyset")
    return root


def _args(root, side, sheet):
    return ["--data", "tinyset", "--data_root", str(root / "datasets"),
            "--ckpt_root", str(root / side), "--ckpt", "run",
            "--methods", "m1,m2", "--sheet", sheet]


def _read_workbook(path):
    """{sheet name: {(column, row): str or float}}."""
    with zipfile.ZipFile(path) as z:
        names = _SHEET.findall(z.read("xl/workbook.xml").decode())
        out = {}
        for i, name in enumerate(names):
            xml = z.read(f"xl/worksheets/sheet{i + 1}.xml").decode()
            out[name] = {(col, int(row)): (float(v) if v else s)
                         for col, row, v, s in _CELL.findall(xml)}
    return out


@pytest.mark.parametrize("sheet", ["method", "metric"])
def test_eval_cli_matches_jax(dump, sheet, capsys):
    want_path = jax_eval_cli.main(_args(dump, "jax", sheet))
    got_path = eval_cli.main(_args(dump, "port", sheet) + ["--device",
                                                           "cpu"])
    out = capsys.readouterr().out
    assert "skipping 4.png: no fused result" in out
    assert out.count("evaluating 1.png ... done") == 2   # once per CLI
    assert os.path.basename(got_path) == os.path.basename(want_path) \
        == "metrics_tinyset_m1.xlsx"
    want, got = _read_workbook(want_path), _read_workbook(got_path)
    assert list(got) == list(want)
    n_sheets = 2 if sheet == "method" else 16
    assert len(got) == n_sheets
    for name in want:
        assert sorted(got[name]) == sorted(want[name]), name
        viff_sheet = name == "VIFF"
        for cell, w in want[name].items():
            g = got[name][cell]
            if isinstance(w, str):
                assert g == w, (name, cell)
                continue
            viff = viff_sheet or (sheet == "method" and cell[0] == "Q")
            tol = 1e-3 if viff else 1e-4
            np.testing.assert_allclose(g, w, rtol=tol, atol=tol,
                                       err_msg=f"{name} {cell}")
    first = got["m1"] if sheet == "method" else got["SSIM"]
    # three pairs: the header, mean, std and one row per image
    assert [first[("A", r)] for r in range(2, 7)] == [
        "mean", "std", "1.png", "2.png", "3.png"]


def test_eval_rows_do_not_depend_on_chunking(dump, monkeypatch):
    d = dump / "datasets" / "tinyset" / "test"
    imgf = dump / "port" / "run" / "tinyset"
    names, rows = eval_cli.eval_method(str(d / "vis"), str(d / "ir"),
                                       str(imgf), "cpu")
    monkeypatch.setattr(eval_cli, "CHUNK", 1)
    names1, rows1 = eval_cli.eval_method(str(d / "vis"), str(d / "ir"),
                                         str(imgf), "cpu")
    assert names == names1 == ["1.png", "2.png", "3.png"]
    for a, b in zip(rows, rows1):
        for k in eval_cli.METRIC_KEYS:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-5, atol=1e-6)


def test_write_workbook_layouts(tmp_path):
    rows = [{k: float(i + j) for j, k in enumerate(eval_cli.METRIC_KEYS)}
            for i in range(2)]
    path = str(tmp_path / "m.xlsx")
    book = eval_cli.write_workbook(path, "a", ["x", "y"], rows, "metric")
    eval_cli.write_workbook(path, "b", ["x", "y"], rows, "metric", book, 1)
    wb = _read_workbook(path)
    assert list(wb) == eval_cli.METRIC_LABELS
    assert wb["SD"][("B", 1)] == "a" and wb["SD"][("C", 1)] == "b"
    # mean, then the std of the column with the mean already in it (the
    # JAX package's and the reference's order)
    assert wb["SD"][("B", 2)] == 0.5
    assert wb["SD"][("B", 3)] == pytest.approx(np.std([0.5, 0.0, 1.0]))


def test_xlsx_writer_same_bytes_as_jax(tmp_path):
    from multi_modal_image_fusion_tpu.utils.xlsx import Workbook as JBook
    books = {}
    for name, cls in (("port", Workbook), ("jax", JBook)):
        book = cls()
        book.set_column("s<1>", 0, ["", "mean", "a & b", 1.5, 2, True])
        book.set_cell("other", 3, 30, -0.25)
        path = str(tmp_path / f"{name}.xlsx")
        book.save(path)
        with zipfile.ZipFile(path) as z:
            books[name] = {n: z.read(n) for n in z.namelist()}
    assert books["port"] == books["jax"]


def test_eval_cli_spatial_raises(dump):
    with pytest.raises(NotImplementedError, match="queue 1 item 7"):
        eval_cli.main(_args(dump, "port", "method") + ["--spatial", "2",
                                                       "--device", "cpu"])


def test_eval_cli_needs_card_or_cpu_flag(dump):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError):
        eval_cli.main(_args(dump, "port", "method"))
