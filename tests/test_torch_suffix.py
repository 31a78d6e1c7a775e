"""genometools_torch suffix engine and ESA writers against the reference
(JAX on the CPU) and gt's own goldens, plus the JAX-free CLI.
Comparisons are exact (integers and bytes)."""

import gzip
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from genometools_torch.index.esa import build_esa, write_esa
from genometools_torch.index.suffix import build_suffix_array

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "golden_esa"
DBS = sorted(p.name for p in GOLDEN.iterdir() if p.is_dir())


def _keys(rng, case):
    n = int(rng.integers(200, 3000))
    keys = rng.integers(0, 4, n + 1).astype(np.int32)
    if case == "repeats":
        unit = keys[:7].copy()
        keys[:n - 40] = np.tile(unit, n // 7 + 1)[:n - 40]
    sp = rng.choice(n, n // 20, replace=False)
    if case == "noncanonical":
        keys[sp] = 253                         # position-independent
    else:
        keys[sp] = 4 + sp
    keys[n] = 4 + n
    return keys


@pytest.mark.parametrize("case", ["specials", "repeats", "noncanonical"])
def test_suffix_engine_matches_reference(case):
    from genometools_tpu.index.suffix import build_suffix_array as ref_bsa
    keys = _keys(np.random.default_rng(len(case)), case)
    ref_sa, ref_lcp = ref_bsa(keys)
    sa, lcp = build_suffix_array(keys, device="cpu")
    assert np.array_equal(np.asarray(ref_sa), sa.numpy())
    assert np.array_equal(np.asarray(ref_lcp), lcp.numpy())


def _golden_bytes(db, ext):
    p = GOLDEN / db / f"idx.{ext}"
    return p.read_bytes() if p.exists() else \
        gzip.open(f"{p}.gz").read()


@pytest.mark.parametrize("db", DBS)
def test_writers_reproduce_goldens(db, tmp_path):
    from genometools_tpu.core.encseq import Encseq
    enc = Encseq.load(str(GOLDEN / db / "idx"))
    esa = build_esa(enc, device="cpu", with_bck=True)
    write_esa(esa, str(tmp_path / "idx"), bwt=True, bck=True)
    for ext in ("suf", "lcp", "llv", "prj", "bwt", "bck"):
        assert (tmp_path / f"idx.{ext}").read_bytes() == \
            _golden_bytes(db, ext), ext


def _write_fasta(enc, path):
    lut = np.frombuffer(b"acgtn", np.uint8)
    with open(path, "wb") as f:
        for s in range(enc.num_sequences):
            lo, hi = int(enc.seq_startpos(s)), int(enc.seq_endpos(s))
            c = enc.codes[lo:hi + 1]
            f.write(b">" + enc.descs[s].encode("latin-1") + b"\n")
            f.write(lut[np.where(c < 4, c, 4)].tobytes() + b"\n")


def test_cli_runs_without_jax(tmp_path):
    """suffixerator + seed_extend through `genometools_torch.cli` in a
    process where importing jax or genometools_tpu fails."""
    from genometools_tpu.core.encseq import Encseq

    from genometools_torch.match.seed_extend import (SeedExtendParams,
                                                     seed_extend)
    db = "Duplicate.fna"
    _write_fasta(Encseq.load(str(GOLDEN / db / "idx")), tmp_path / "in.fa")
    script = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['genometools_tpu'] = None\n"
        "import torch\n"
        "torch.set_num_threads(1)\n"
        "from genometools_torch.cli import main\n"
        "main(['suffixerator', '-db', 'in.fa', '-indexname', 'idx',\n"
        "      '-suf', '-lcp', '-tis', '-device', 'cpu'])\n"
        "main(['seed_extend', '-ii', 'idx', '-l', '14', '-minidentity',\n"
        "      '90', '-extendgreedy', '-device', 'cpu'])\n"
        "assert 'jax' not in sys.modules or sys.modules['jax'] is None\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", script], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    for ext in ("suf", "lcp", "llv"):
        assert (tmp_path / f"idx.{ext}").read_bytes() == \
            _golden_bytes(db, ext), ext
    p = SeedExtendParams(minidentity=90, userdefinedleastlength=14,
                         extension="greedy")
    want = [m.line() for m in seed_extend(
        Encseq.load(str(tmp_path / "idx")), None, p, engine="fused")]
    assert out.stdout.splitlines() == want and want


def test_cuda_request_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        build_suffix_array(np.array([1, 0, 5], np.int32), device="cuda")
