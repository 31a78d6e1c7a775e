"""genometools_torch seed_extend's -parts/-pick grid, -maxmat and -estim
against the reference package on the CPU (the wave path's extensions in
the plain versions of K1, K2r and K3), line for line, for
self-comparison and for a query index, both strands and both
extensions. Every comparison is exact; estim's reports character for
character."""

import contextlib
import io
from pathlib import Path

import numpy as np
import pytest
import torch

from genometools_torch.core.encseq import Encseq
from genometools_torch.match import seed_extend as tse

torch.set_num_threads(1)

GOLDEN = Path(__file__).resolve().parents[1] / "tests" / "golden_esa"
_COMP = str.maketrans("acgt", "tgca")


def _planted_text(seed, nseq=6, n=500):
    """nseq random sequences; pieces of 100-200 symbols copied between
    them forward and reverse complemented, with a few substitutions."""
    rng = np.random.default_rng(seed)
    seqs = ["".join(rng.choice(list("acgt"), n)) for _ in range(nseq)]
    for t in range(2 * nseq):
        a, b = (int(x) for x in rng.choice(nseq, 2, replace=False))
        L = int(rng.integers(100, 200))
        p, q = (int(x) for x in rng.integers(0, n - L, 2))
        piece = list(seqs[a][p:p + L])
        for x in rng.integers(0, L, 3):
            piece[x] = "acgt"[int(rng.integers(0, 4))]
        piece = "".join(piece)
        if t % 2:
            piece = piece.translate(_COMP)[::-1]
        seqs[b] = seqs[b][:q] + piece + seqs[b][q + L:]
    return seqs


def _pair(seed):
    """(db text, query text): the query shares planted pieces with the
    db on both strands."""
    db = _planted_text(seed)
    rng = np.random.default_rng(seed + 100)
    q = []
    for i in range(4):
        s = "".join(rng.choice(list("acgt"), 400))
        piece = db[i][100:300]
        if i % 2:
            piece = piece.translate(_COMP)[::-1]
        q.append(s[:200] + piece + s[200:])
    return "|".join(db), "|".join(q)


def _encs(seed, query):
    from genometools_tpu.core.encseq import Encseq as RefEncseq
    db, q = _pair(seed)
    out = [RefEncseq.from_string(db), Encseq.from_string(db)]
    out += [RefEncseq.from_string(q), Encseq.from_string(q)] if query \
        else [None, None]
    return out


def _params(ext, **kw):
    from genometools_tpu.match import seed_extend as rse
    return rse.SeedExtendParams(seedlength=12, minidentity=85,
                                userdefinedleastlength=30, extension=ext,
                                **kw)


def _lines(ms):
    return [m.line() for m in ms]


@pytest.mark.parametrize("query", [False, True], ids=["self", "query"])
@pytest.mark.parametrize("ext", ["greedy", "xdrop"])
@pytest.mark.parametrize("parts", [2, 3, 4])
def test_grid_matches_reference(parts, ext, query):
    """The wave grid equals the reference's grid line for line, in grid
    order, on both strands; the fused grid equals it too."""
    from genometools_tpu.match import seed_extend as rse
    renc, enc, rq, q = _encs(parts, query)
    p = _params(ext, parts=parts)
    want = _lines(rse.seed_extend(renc, rq, p))
    got = _lines(tse.seed_extend(enc, q, tse.params_from_reference(p),
                                 device="cpu"))
    fused = _lines(tse.seed_extend(enc, q, tse.params_from_reference(p),
                                   engine="fused"))
    assert got == want == fused
    assert {line.split()[3] for line in want} == {"F", "P"}
    # parts invariance: the reference's own bar, sorted lines
    one = _lines(tse.seed_extend(enc, q, tse.params_from_reference(
        _params(ext)), device="cpu"))
    assert sorted(got) == sorted(one)


@pytest.mark.parametrize("query", [False, True], ids=["self", "query"])
def test_pick_cells_match_reference(query):
    """Every -pick cell equals the reference's; concatenated in grid
    order they are the -parts output."""
    from genometools_tpu.match import seed_extend as rse
    renc, enc, rq, q = _encs(7, query)
    nr = len(tse.sequence_ranges(enc, 3))
    assert nr == len(rse.sequence_ranges(renc, 3)) == 3
    cells = []
    for a in range(1, nr + 1):
        for b in range(a if not query else 1, nr + 1):
            p = _params("greedy", parts=3, pick=(a, b))
            want = _lines(rse.seed_extend(renc, rq, p))
            got = _lines(tse.seed_extend(
                enc, q, tse.params_from_reference(p), device="cpu"))
            assert got == want
            cells += got
    whole = _lines(tse.seed_extend(enc, q, tse.params_from_reference(
        _params("greedy", parts=3)), device="cpu"))
    assert cells == whole and whole


def test_pick_errors(tmp_path, capsys):
    from genometools_torch.cli import main
    enc = Encseq.from_string("|".join(_planted_text(3)))
    with pytest.raises(ValueError, match="must not exceed 3"):
        tse.seed_extend(enc, None, tse.SeedExtendParams(
            parts=3, pick=(1, 4)), device="cpu")
    enc.save(str(tmp_path / "idx"))
    # the option table refuses -pick without -parts, as the reference's
    # main does: exit 2 with gt's message
    with pytest.raises(SystemExit) as e:
        main(["seed_extend", "-ii", str(tmp_path / "idx"), "-pick", "1,1",
              "-device", "cpu"])
    assert e.value.code == 2
    assert capsys.readouterr().err.endswith(
        'error: option "-pick" requires option "-parts"\n')


def test_cli_refuses_dist_and_runs_parts(tmp_path):
    """-parts 2 runs and prints the reference CLI's bytes, and so does
    -parts 2 -dist 2 (ported: the grid's cells on a mesh's lanes)."""
    from genometools_tpu.cli import main as ref_main

    from genometools_torch.cli import main
    enc = Encseq.from_string("|".join(_planted_text(5)))
    enc.save(str(tmp_path / "idx"))
    argv = ["seed_extend", "-ii", str(tmp_path / "idx"), "-l", "40",
            "-seedlength", "12", "-parts", "2"]
    out = []
    for run, extra in ((ref_main, ["--cpu"]), (main, ["-device", "cpu"]),
                       (main, ["-dist", "2", "-device", "cpu"])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            run(argv + extra)
        out.append(buf.getvalue())
    assert out[2] == out[1] == out[0] and out[0]


@pytest.mark.parametrize("db,seedlength,minlength", [
    ("Atinsert.fna", 14, 20), ("Duplicate.fna", 20, 30),
    ("at1MB", 32, 250)])
def test_maxmat_matches_reference(db, seedlength, minlength):
    from genometools_tpu.core.encseq import Encseq as RefEncseq
    from genometools_tpu.match.seed_extend import \
        maximal_exact_matches as ref_mem
    idx = str(GOLDEN / db / "idx")
    want = ref_mem(RefEncseq.load(idx), None, seedlength, minlength)
    got = tse.maximal_exact_matches(Encseq.load(idx), None, seedlength,
                                    minlength)
    assert [vars(m) for m in got] == [vars(m) for m in want] and want


def test_maxmat_query_matches_reference():
    from genometools_tpu.match.seed_extend import \
        maximal_exact_matches as ref_mem
    renc, enc, rq, q = _encs(9, True)
    want = ref_mem(renc, rq, 12, 30)
    got = tse.maximal_exact_matches(enc, q, 12, 30)
    assert [vars(m) for m in got] == [vars(m) for m in want] and want


@pytest.mark.parametrize("mode", ["ANI", "JKD"])
@pytest.mark.parametrize("delta", [False, True], ids=["all", "delta"])
@pytest.mark.parametrize("query", [False, True], ids=["self", "query"])
def test_estim_matches_reference(mode, delta, query):
    from genometools_tpu.match.estim import seed_extend_estim as ref_estim

    from genometools_torch.match.estim import seed_extend_estim
    renc, enc, rq, q = _encs(11, query)
    kw = dict(mode=mode, delta_filter=delta, aname="a", bname="b")
    want = ref_estim(renc, rq, _params("greedy"), **kw)
    got = seed_extend_estim(enc, q, tse.params_from_reference(
        _params("greedy")), **kw)
    assert got == want and mode in want


def test_estim_bias_parameters_match_reference():
    from genometools_tpu.match.estim import seed_extend_estim as ref_estim

    from genometools_torch.match.estim import seed_extend_estim
    renc, enc, rq, q = _encs(13, True)
    kw = dict(mode="ANI", bias_parameters=True, aname="a", bname="b")
    want = ref_estim(renc, rq, _params("greedy"), **kw)
    got = seed_extend_estim(enc, q, tse.params_from_reference(
        _params("greedy")), **kw)
    assert got == want


@pytest.mark.parametrize("selfcomp,maxfreq", [(True, None), (False, None),
                                              (True, 3)])
def test_numpy_join_matches_native(selfcomp, maxfreq):
    """The numpy join that 32-mers take (the native join's packed words
    cannot hold them) equals the native join on 12-mers."""
    renc, enc, rq, q = _encs(15, not selfcomp)
    alist = tse.enumerate_kmers(enc, 12)
    blist = alist if selfcomp else tse.enumerate_kmers(q, 12, revcomp=True)
    for mindist in (12, 0):
        want = tse.build_seed_pairs(alist, blist, selfcomp, maxfreq,
                                    mindist=mindist)
        got = tse._numpy_seed_pairs(alist, blist, selfcomp, maxfreq, True,
                                    mindist, None)
        assert all(np.array_equal(a, b) for a, b in zip(got, want))
        assert want[0].size
