"""genometools_torch's -parts/-memlimit engine (index/parts.py) against
the reference's (genometools_tpu/index/parts.py) on in-repo data: the
same suffix tables and the same bytes for every budget and readmode,
invariant to the part count (the reference's checksfx discipline), and
the port's CLI route with JAX and the reference blocked. Exact."""

import gzip
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from genometools_tpu.core.encseq import Encseq as RefEncseq
from genometools_tpu.index import parts as ref_parts
from genometools_torch.core.encseq import Encseq
from genometools_torch.index import parts
from genometools_torch.index.esa import build_esa, write_esa
from genometools_torch.index.suffix import build_suffix_array

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "golden_esa"
OUT = (".suf", ".lcp", ".llv", ".bwt", ".bck", ".prj")


def _random_string(seed: int, n: int) -> str:
    rng = np.random.default_rng(seed)
    s = "".join(rng.choice(list("acgtn"), n, p=[0.235] * 4 + [0.06]))
    return s[:n // 3] + "|" + s[n // 3:]


@pytest.mark.parametrize("budget", [37, 500, 10 ** 9])
def test_suftab_parts_match_reference(budget):
    s = _random_string(3, 4000)
    e = Encseq.from_string(s)
    got = parts.build_suftab_parts(e.codes, budget)
    want = ref_parts.build_suftab_parts(RefEncseq.from_string(s).codes,
                                        budget)
    assert np.array_equal(got, want)
    sa, _ = build_suffix_array(e.suffix_keys(), with_lcp=False,
                               device="cpu")
    assert np.array_equal(got, sa.numpy())


def test_plan_matches_reference():
    s = _random_string(5, 20000).replace("|", "")
    plan = parts.plan_parts(Encseq.from_string(s).codes, 1000)
    rplan = ref_parts.plan_parts(RefEncseq.from_string(s).codes, 1000)
    assert np.array_equal(plan.bounds, rplan.bounds)
    assert np.array_equal(plan.counts, rplan.counts)
    assert (plan.counts <= 1000).all()
    assert int(plan.counts.sum()) == plan.num_regular


@pytest.mark.parametrize("rm", [0, 1, 2, 3])
def test_stream_parts_bytes_match_reference(rm, tmp_path):
    """Every output of stream_esa_parts equals the reference's for
    several budgets, and the port's in-memory build_esa + write_esa."""
    idx = str(GOLDEN / "Atinsert.fna" / "idx")
    e = Encseq.load(idx)
    re_ = RefEncseq.load(idx)
    esa = build_esa(e, rm, with_lcp=True, with_bck=True, device="cpu")
    mem = str(tmp_path / "mem")
    write_esa(esa, mem, suf=True, lcp=True, bwt=True, bck=True)
    for budget in (10 ** 9, 4000, 701):
        got, want = str(tmp_path / f"p{budget}"), str(tmp_path / f"r{budget}")
        kw = dict(suf=True, lcp=True, bwt=True, bck=True,
                  prefixlength=esa.prefixlength)
        nparts = parts.stream_esa_parts(e, rm, got, budget, **kw)
        assert nparts == ref_parts.stream_esa_parts(re_, rm, want, budget,
                                                    **kw)
        assert budget > 10 ** 6 or nparts > 1
        for ext in OUT:
            g = Path(got + ext).read_bytes()
            assert g == Path(want + ext).read_bytes(), (ext, budget)
            assert g == Path(mem + ext).read_bytes(), (ext, budget)


def _golden(db, ext):
    p = GOLDEN / db / f"idx.{ext}"
    return p.read_bytes() if p.exists() else gzip.open(f"{p}.gz").read()


def test_cli_parts_and_memlimit_without_jax(tmp_path):
    """suffixerator -parts 2 and -memlimit through the port's CLI in a
    process where importing jax or genometools_tpu fails: the files
    equal gt's goldens."""
    db = "Random.fna"
    enc = Encseq.load(str(GOLDEN / db / "idx"))
    lut = np.frombuffer(b"acgtn", np.uint8)
    with open(tmp_path / "in.fa", "wb") as f:
        for s in range(enc.num_sequences):
            lo, hi = int(enc.seq_startpos(s)), int(enc.seq_endpos(s))
            c = enc.codes[lo:hi + 1]
            f.write(b">" + enc.descs[s].encode("latin-1") + b"\n")
            f.write(lut[np.where(c < 4, c, 4)].tobytes() + b"\n")
    base = ["suffixerator", "-db", "in.fa", "-suf", "-lcp", "-tis",
            "-device", "cpu"]
    runs = {"p2": ["-parts", "2"], "ml": ["-memlimit", "64KB"]}
    script = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['genometools_tpu'] = None\n"
        "import torch\n"
        "torch.set_num_threads(1)\n"
        "from genometools_torch.cli import main\n"
        f"for name, extra in {runs!r}.items():\n"
        f"    main({base!r} + ['-indexname', name] + extra)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", script], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    for name in runs:
        for ext in ("suf", "lcp", "llv", "prj"):
            assert (tmp_path / f"{name}.{ext}").read_bytes() == \
                _golden(db, ext), (name, ext)
