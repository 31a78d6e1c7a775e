"""ltrharvest, tirvish and ltrclustering in genometools_torch against the
reference package on planted-transposon genomes of 40-60 kbp
(``utils/synthetic.py::planted_transposons``, numpy seeds below): the
predictions, the tabular lines, the GFF3 and the FASTA bytes must be
equal, on the batch route (the xdrop lanes through
``xdrop_extend_batch_pool``: K3's plain version on the CPU, at quantum
4) and on the port's host route (``engine="host"``, the reference's
per-pair loop). All comparisons are exact.
"""

import numpy as np
import pytest
import torch

from genometools_torch.anno import gff3 as tgff
from genometools_torch.core.encseq import Encseq as TEncseq
from genometools_torch.ltr import ltrclustering as tlc
from genometools_torch.ltr import ltrharvest as tlh
from genometools_torch.ltr import tirvish as ttv
from genometools_torch.ops import xdrop_batch as txb
from genometools_torch.utils.synthetic import planted_transposons

torch.set_num_threads(1)


def _genome(seed, length=40000, ltr=2, tir=2, divergence=(0.0, 0.10),
            tsd=True, families=40):
    seqs, planted = planted_transposons(
        seed=seed, nseq=2, length=length, ltr=ltr, tir=tir,
        wildcard_runs=2, divergence=divergence, tsd=tsd, families=families)
    text = "|".join(s.decode() for s in seqs)
    return text, planted


def _pair(text):
    from genometools_tpu.core.encseq import Encseq as REncseq
    t, r = TEncseq.from_string(text), REncseq.from_string(text)
    # descriptions for -seqids
    t.descs = r.descs = [f"chr{i} planted" for i in range(t.num_sequences)]
    return t, r


# (seed, divergence, tsd planted, ltrharvest options)
LTR_CASES = [(3, (0.0, 0.10), True, dict(with_tsd=True)),
             (5, (0.0, 0.02), False, dict(with_tsd=False)),
             (11, (0.05, 0.10), True, dict(with_tsd=True, similar=80.0)),
             (19, (0.0, 0.05), True, dict(with_tsd=True, mintsd=5,
                                          seedlength=25))]


@pytest.mark.parametrize("case", LTR_CASES)
def test_ltrharvest_matches_reference(case):
    from genometools_tpu.anno.gff3 import gff3_to_string
    from genometools_tpu.ltr import ltrharvest as rlh
    seed, div, tsd, opts = case
    text, planted = _genome(seed, 60000, ltr=3, tir=1, divergence=div,
                            tsd=tsd)
    t, r = _pair(text)
    ref = rlh.ltrharvest(r, rlh.LTRHarvestParams(**opts))
    params = tlh.LTRHarvestParams(**opts)
    txb.reset_stats()
    trace = {}
    got = tlh.ltrharvest(t, params, device="cpu", trace=trace)
    host = tlh.ltrharvest(t, params, device="cpu", engine="host")
    assert [vars(p) for p in got] == [vars(p) for p in ref]
    assert [vars(p) for p in host] == [vars(p) for p in ref]
    assert ref, "no LTR element predicted"
    assert trace["lanes"] > 0 and txb.stats["kernel_lanes"] > 0
    for longoutput in (False, True):
        assert tlh.tabout_lines(got, t, longoutput) == \
            rlh.tabout_lines(ref, r, longoutput)
    for seqids in (False, True):
        assert tgff.gff3_to_string(tlh.gff3_nodes(got, t, seqids)) == \
            gff3_to_string(rlh.gff3_nodes(ref, r, seqids))
    for inner in (False, True):
        assert tlh.fasta_out_entries(got, t, inner) == \
            rlh.fasta_out_entries(ref, r, inner)
    # every prediction lies on a planted LTR element (the xdrop at
    # belowscore 5 often stops inside the LTRs, so the ends are not
    # compared)
    ltrs = planted[planted[:, 0] == 0]
    for p in got:
        assert any(p.seqnum == row[1] and p.start1 <= row[5] and
                   row[2] <= p.end2 for row in ltrs), vars(p)


def test_ltrharvest_where_reference_raises():
    """On this genome the reference's similarity raises KeyError (an
    empty diagonal inside the untrimmed greedy front, ROADMAP Queue 3);
    the port's batch and host routes agree."""
    from genometools_tpu.ltr import ltrharvest as rlh
    text, _ = _genome(17, 60000, ltr=3, tir=1, divergence=(0.0, 0.05))
    t, r = _pair(text)
    opts = dict(with_tsd=True, mintsd=5, seedlength=25)
    with pytest.raises(KeyError):
        rlh.ltrharvest(r, rlh.LTRHarvestParams(**opts))
    params = tlh.LTRHarvestParams(**opts)
    got = tlh.ltrharvest(t, params, device="cpu")
    host = tlh.ltrharvest(t, params, device="cpu", engine="host")
    assert got and [vars(p) for p in got] == [vars(p) for p in host]


def test_similarity_is_the_scalar_engine():
    """The similarity of every candidate equals the one the scalar
    engine gives the reference's ``_similarity``, wherever that engine
    returns; on the planted LTR pairs where it raises (a cell dropped
    past a sequence end leaves an empty diagonal inside the front), the
    port returns the walk's distance. The native greedy batch without
    trims disagrees on some candidate, so the port keeps the scalar
    walk."""
    from genometools_tpu.ops.greedy import greedy_extend

    from genometools_torch.core.native import greedy_batch_native
    from genometools_torch.ops.greedy import PolishingInfo
    text, planted = _genome(3, 40000)
    t, _ = _pair(text)
    # the candidate ltrharvest keeps on this genome, then the planted LTR
    # pairs, whole and cut to their first 100 and 300 bp
    rows = [(5155, 5281, 10648, 10774)]
    for row in planted[planted[:, 0] == 0]:
        lo = int(t.seq_startpos(row[1]))
        for cut in (10 ** 9, 100, 300):
            rows.append((lo + row[2], lo + min(row[3], row[2] + cut),
                         lo + row[4], lo + min(row[5], row[4] + cut)))
    rows = np.asarray(rows, np.int64)
    got = tlh.similarities(t.codes, rows)
    raised = 0
    for r, g in zip(rows, got):
        u, v = t.codes[r[0]:r[1] + 1], t.codes[r[2]:r[3] + 1]
        d = tlh.untrimmed_distance(u, v)
        try:
            assert greedy_extend(u, v, trim=False, perc_mat_history=0,
                                 maxalignedlendifference=10 ** 9)[0] == d
        except KeyError:
            raised += 1
        assert g == (0.0 if d > u.size + v.size
                     else 100.0 * (1.0 - 2.0 * d / (u.size + v.size)))
    assert 0 < raised < len(rows)
    nat = greedy_batch_native(
        [t.codes[r[0]:r[1] + 1] for r in rows],
        [t.codes[r[2]:r[3] + 1] for r in rows], max_history=64,
        perc_mat_history=0, maxalignedlendifference=10 ** 9,
        seedlengths=np.zeros(len(rows), np.int64),
        pol=PolishingInfo.new(0.0, 64), trim=False)
    walk = [tlh.untrimmed_distance(t.codes[r[0]:r[1] + 1],
                                   t.codes[r[2]:r[3] + 1]) for r in rows]
    assert (nat[:, 2] != np.asarray(walk)).any()


# (seed, tirvish options): the defaults, then -mis -1 (unit distances
# (3, 4, 4): every lane on the scalar engine), then -overlaps longest
TIR_CASES = [(5, {}), (5, dict(mis=-1)), (23, dict(overlaps="longest")),
             (29, dict(min_tsd_length=3, vicinity=40))]


@pytest.mark.parametrize("case", TIR_CASES)
def test_tirvish_matches_reference(case):
    from genometools_tpu.anno.gff3 import gff3_to_string
    from genometools_tpu.ltr import tirvish as rtv
    seed, opts = case
    text, _ = _genome(seed, 40000, ltr=1, tir=3)
    t, r = _pair(text)
    ref = rtv.tirvish(r, rtv.TIRvishParams(**opts))
    txb.reset_stats()
    got = ttv.tirvish(t, ttv.TIRvishParams(**opts), device="cpu")
    host = ttv.tirvish(t, ttv.TIRvishParams(**opts), device="cpu",
                       engine="host")
    assert [vars(q) for q in got] == [vars(q) for q in ref]
    assert [vars(q) for q in host] == [vars(q) for q in ref]
    assert ref, "no TIR element predicted"
    assert tgff.gff3_to_string(ttv.gff3_nodes(got, t)) == \
        gff3_to_string(rtv.gff3_nodes(ref, r))
    if opts.get("mis") == -1:
        assert txb.stats["scalar_lanes"] > 0 and \
            txb.stats["kernel_lanes"] == 0
    else:
        assert txb.stats["kernel_lanes"] > 0 and \
            txb.stats["scalar_lanes"] == 0


def test_tirvish_refuses_xdrop_beyond_ring():
    """-xdrop beyond K3's ring at the default scores (254 at quantum 4)
    is refused before any work, by the library and by the CLI; with
    -mis -1 the lanes take the scalar engine and any -xdrop runs."""
    import contextlib
    import io
    from pathlib import Path
    from genometools_torch.cli import main
    text, _ = _genome(7, 20000, ltr=0, tir=2)
    t = TEncseq.from_string(text)
    with pytest.raises(ValueError):
        ttv.tirvish(t, ttv.TIRvishParams(xdrop_belowscore=255),
                    device="cpu")
    ttv.tirvish(t, ttv.TIRvishParams(xdrop_belowscore=255, mis=-1),
                device="cpu")
    idx = Path(__file__).resolve().parent / "golden_esa" / "Atinsert.fna"
    with pytest.raises(SystemExit, match="-xdrop"), \
            contextlib.redirect_stdout(io.StringIO()):
        main(["tirvish", "-index", str(idx / "idx"), "-xdrop", "255",
              "-device", "cpu"])


def test_tsd_matches_equal_the_reference():
    """The table-driven TSD search returns the reference's scalar
    search's matches, in its order."""
    from genometools_tpu.ltr.tirvish import _tsd_matches
    rng = np.random.default_rng(4)
    for _ in range(30):
        db = rng.integers(0, 4, int(rng.integers(0, 60))).astype(np.uint8)
        q = rng.integers(0, 4, int(rng.integers(0, 60))).astype(np.uint8)
        if db.size > 10 and q.size > 10:
            q[3:9] = db[2:8]
            db[rng.integers(0, db.size)] = 254
        for minlen in (2, 4):
            assert ttv._tsd_matches(db, q, minlen) == \
                _tsd_matches(db, q, minlen)


def _ltr_gff3(seed):
    # one LTR family: the elements' LTRs match each other
    text, _ = _genome(seed, 60000, ltr=4, tir=0, families=1)
    t, r = _pair(text)
    preds = tlh.ltrharvest(t, tlh.LTRHarvestParams(with_tsd=True),
                           device="cpu")
    return t, r, tgff.gff3_to_string(tlh.gff3_nodes(preds, t))


@pytest.mark.parametrize("pp", [(80, 30), (90, 90), (30, 10)])
def test_ltrclustering_matches_reference(pp):
    from genometools_tpu.anno.gff3 import gff3_to_string, parse_gff3
    from genometools_tpu.ltr.ltrclustering import ltrclustering
    t, r, text = _ltr_gff3(3)
    ref = ltrclustering(r, parse_gff3(text), *pp)
    got = tlc.ltrclustering(t, tgff.parse_gff3(text), *pp, device="cpu")
    fused = tlc.ltrclustering(t, tgff.parse_gff3(text), *pp,
                              engine="fused")
    want = gff3_to_string(ref)
    assert tgff.gff3_to_string(got) == want
    assert tgff.gff3_to_string(fused) == want
    assert "clid=" in want and "ltrfam=" in want


def test_ltrclustering_short_group():
    """Repair of the reference's exception swallow: groups of the
    shortest members the clustering takes (10-13 bp: seed length 8),
    a one-member group, and members with wildcards give the reference's
    output with every error left to propagate."""
    from genometools_tpu.anno.gff3 import gff3_to_string, parse_gff3
    from genometools_tpu.core.encseq import Encseq as REncseq
    from genometools_tpu.ltr.ltrclustering import ltrclustering
    rng = np.random.default_rng(9)
    unit = "".join(rng.choice(list("acgt"), 13))
    body = "".join(rng.choice(list("acgt"), 400))
    seq = (body[:50] + unit + body[50:120] + unit[:11] + body[120:200]
           + unit[:10] + "nn" + body[200:300] + "acgtnacgtnacg" + body[300:])
    t, r = TEncseq.from_string(seq), REncseq.from_string(seq)
    starts = [seq.index(unit) + 1, seq.index(unit[:11], 64) + 1,
              seq.index(unit[:10], 145) + 1, seq.index("acgtnacgtn") + 1]
    lens = [13, 11, 10, 13]
    lines = ["##gff-version 3"]
    for k, (s, ln) in enumerate(zip(starts, lens)):
        lines += [f"seq0\tx\trepeat_region\t{s}\t{s + ln + 40}\t.\t?\t.\t"
                  f"ID=r{k}",
                  f"seq0\tx\tLTR_retrotransposon\t{s}\t{s + ln + 40}\t.\t?"
                  f"\t.\tID=e{k};Parent=r{k}",
                  f"seq0\tx\tlong_terminal_repeat\t{s}\t{s + ln - 1}\t.\t?"
                  f"\t.\tParent=e{k}",
                  f"seq0\tx\tlong_terminal_repeat\t{s + 30}\t"
                  f"{s + 30 + ln - 1}\t.\t?\t.\tParent=e{k}"]
    text = "\n".join(lines) + "\n"
    ref = gff3_to_string(ltrclustering(r, parse_gff3(text), 80, 30))
    got = tgff.gff3_to_string(tlc.ltrclustering(t, tgff.parse_gff3(text),
                                                80, 30, device="cpu"))
    assert got == ref
    assert "clid=" in ref
