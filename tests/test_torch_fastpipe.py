"""genometools_torch's suffixerator_e2e on the CPU: every file equals the
reference's suffixerator_e2e (JAX on the CPU) and the port's slow path
(Encseq.save + build_esa + write_esa) byte for byte, and the index files
equal gt's goldens. FASTA is written from the goldens' own sequences."""

import os
from pathlib import Path

import numpy as np
import pytest
import torch

from genometools_tpu.index.fastpipe import suffixerator_e2e as ref_e2e
from genometools_torch.core.encseq import Encseq
from genometools_torch.index.esa import build_esa, write_esa
from genometools_torch.index.fastpipe import suffixerator_e2e

torch.set_num_threads(1)

GOLDEN = Path(__file__).resolve().parent / "golden_esa"
EXTS = ["esq", "ssp", "des", "sds", "md5", "suf", "lcp", "llv", "prj"]


def _write_fasta(enc, path):
    lut = np.frombuffer(b"acgtn", np.uint8)
    with open(path, "wb") as f:
        for s in range(enc.num_sequences):
            lo, hi = int(enc.seq_startpos(s)), int(enc.seq_endpos(s))
            c = enc.codes[lo:hi + 1]
            f.write(b">" + enc.descs[s].encode("latin-1") + b"\n")
            f.write(lut[np.where(c < 4, c, 4)].tobytes() + b"\n")


def _slow(fasta, indexname):
    enc = Encseq.from_files([fasta])
    enc.save(indexname)
    write_esa(build_esa(enc, device="cpu"), indexname)


def _compare(tmp_path, fasta):
    """Run the three writers from the same FASTA path (the .esq header
    records it); return the port's index name."""
    fast, slow, ref = (str(tmp_path / x) for x in ("fast", "slow", "ref"))
    suffixerator_e2e([fasta], fast, device="cpu")
    _slow(fasta, slow)
    ref_e2e([fasta], ref)
    for ext in EXTS:
        f = Path(f"{fast}.{ext}")
        for other in (slow, ref):
            o = Path(f"{other}.{ext}")
            assert f.exists() == o.exists(), (ext, other)
            if o.exists():
                assert f.read_bytes() == o.read_bytes(), (ext, other)
    return fast


# Atinsert and Random carry wildcard runs; Duplicate none
@pytest.mark.parametrize("db", ["Atinsert.fna", "Duplicate.fna",
                                "Random.fna", "small_poly.fas"])
def test_e2e_matches_reference_slow_path_and_goldens(db, tmp_path):
    enc = Encseq.load(str(GOLDEN / db / "idx"))
    fasta = str(tmp_path / "in.fa")
    _write_fasta(enc, fasta)
    fast = _compare(tmp_path, fasta)
    for ext in ("suf", "lcp", "llv", "prj"):
        assert Path(f"{fast}.{ext}").read_bytes() == \
            (GOLDEN / db / f"idx.{ext}").read_bytes(), ext


def test_e2e_random_wildcards_and_long_repeats(tmp_path):
    """Several sequences with wildcard runs and a repeat longer than the
    LCP byte, so .llv holds pairs and refinement takes rounds."""
    rng = np.random.default_rng(7)
    unit = "".join(rng.choice(list("acgt"), 400))
    seqs = []
    for i in range(3):
        s = "".join(rng.choice(list("acgtn"), 211, p=[0.23] * 4 + [0.08]))
        seqs.append(f">s{i}\n{s}{unit}\n")
    p = tmp_path / "wc.fna"
    p.write_text("".join(seqs))
    fast = _compare(tmp_path, str(p))
    assert os.path.getsize(f"{fast}.llv") > 0


def test_e2e_cuda_without_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = tmp_path / "x.fna"
    p.write_text(">x\nacgt\n")
    with pytest.raises(RuntimeError):
        suffixerator_e2e([str(p)], str(tmp_path / "x"))
