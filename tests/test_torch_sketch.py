"""sketch, sketch_page and dot of the port against the reference's, on
annotations made by ``test_torch_anno.make_annotation`` (numpy seeds) and
a style file written here. Both packages draw with the same Pillow, so
SVG and PNG files are equal byte for byte; the PDF files are equal once
Pillow's creation and modification dates (the clock at save time) are
masked.
"""

import re
from pathlib import Path

import pytest

from test_torch_anno import _run, make_annotation

STYLE = """\
-- a style table in the reference's .style format
style = {
  gene = { fill = {red=0.9, green=0.5, blue=0.1}, stroke = {red=0.1,
           green=0.1, blue=0.1} },
  mRNA = { fill = {red=0.2, green=0.4, blue=0.9, alpha=0.5} },
  exon = { fill = {red=0.3, green=0.8, blue=0.3}, collapse_to_parent = false },
  format = { show_grid = true, margins = 30 },
}
"""


def write_inputs(d: Path) -> None:
    text, _, _ = make_annotation(7, nseq=2, genes=12)
    (d / "a.gff3").write_text(text)
    one, _, _ = make_annotation(10, nseq=1, genes=6, shuffle=False)
    (d / "one.gff3").write_text(one)
    (d / "s.style").write_text(STYLE)
    (d / "bad.style").write_text("nostyle = {}\n")


CASES = {
    "svg": ["sketch", "out.svg", "a.gff3"],
    "svg_seqid": ["sketch", "-seqid", "chr2", "-width", "600", "out.svg",
                  "a.gff3"],
    "svg_style": ["sketch", "-style", "s.style", "out.svg", "one.gff3"],
    "png": ["sketch", "out.png", "one.gff3"],
    "png_recmaps": ["sketch", "-showrecmaps", "-style", "s.style",
                    "-width", "1000", "out.png", "a.gff3"],
    "pdf_format": ["sketch", "-format", "pdf", "out.img", "one.gff3"],
    "bad_style": ["sketch", "-style", "bad.style", "out.svg", "one.gff3"],
    "page": ["sketch_page", "pages.pdf", "a.gff3"],
    "page_span": ["sketch_page", "-linewidth", "15000", "-style", "s.style",
                  "-seqid", "chr1", "pages.pdf", "a.gff3"],
    "dot": ["dot", "one.gff3"],
    "dot_two": ["dot", "a.gff3", "one.gff3"],
}


def _unclocked(data: bytes) -> bytes:
    """A PDF with its /CreationDate and /ModDate values masked."""
    return re.sub(rb"/(CreationDate|ModDate) ?\(D:[^)]*\)", rb"/\1 (D:)",
                  data)


def _files(d: Path) -> dict:
    return {p.name: _unclocked(p.read_bytes()) for p in sorted(d.iterdir())}


@pytest.mark.parametrize("case", sorted(CASES))
def test_cli_matches_reference(case, tmp_path):
    pytest.importorskip("PIL")
    from genometools_tpu.cli import main as ref_main

    from genometools_torch.cli import main
    got = []
    for side, fn in (("ref", ref_main), ("port", main)):
        d = tmp_path / side
        d.mkdir()
        write_inputs(d)
        got.append(_run(fn, CASES[case], d))
    assert got[1] == got[0]
    assert _files(tmp_path / "port") == _files(tmp_path / "ref")
    rc, out = got[0][:2]
    if case == "bad_style":
        assert rc[:2] == ("raised", "StyleError")
        return
    assert rc == 0
    outs = [p for p in (tmp_path / "port").iterdir()
            if p.name.startswith(("out", "pages"))]
    if case.startswith("dot"):
        assert out.startswith("digraph {") and out.count("->") > 10
    else:
        head = outs[0].read_bytes()[:8]
        assert head.startswith({"svg": b"<", "png": b"\x89PNG",
                                "pdf": b"%PDF"}[
            "svg" if case.startswith("svg") or case == "bad_style" else
            "png" if case.startswith("png") else "pdf"])
    if case == "png_recmaps":
        assert out.count("\n") > 20 and ", exon" in out
