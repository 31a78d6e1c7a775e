"""Input generator: gt shredder's read set of GenomeTools' at1MB test
genome (real Arabidopsis thaliana sequence, 772,376 symbols in 1,952
sequences), kept under portbench/data/at1MB as gt's own encoded
sequence (.esq, .ssp).

Frozen here: the .esq reader is cut down from
``genometools_torch/core/esq.py::read_esq`` and the shredder copied
from ``genometools_torch/utils/seqtools.py::shredder``, both at commit
f3ca459de4d5. The reader keeps the access types whose wildcards sit in
a table (gt's uchar, ushort and uint32 tables; at1MB's is uchar) and
raises on the others.

The read set is shredded with the cell's fixed `shred_seed`, so every
run aligns the same reads and does the same work; the run's seed draws
`orders` orders of them, one FASTA file each (the order sets every
sequence number and which read of a pair is the a side). The warm-up
aligns the last file and the window's jobs take the others in turn, so
no job of a window repeats the input of the job before it.

Parameters (from the cell): shred_seed, coverage, minlength,
maxlength, overlap, orders.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..harness import variant_walks
from .synthetic import write_fasta

DATA = Path(__file__).resolve().parent.parent / "data" / "at1MB"

_SW_MAX = {4: 0xFF, 5: 0xFFFF, 6: 0xFFFFFFFF}
_SW_DTYPE = {4: np.uint8, 5: np.uint16, 6: np.uint32}


class _Reader:
    def __init__(self, buf: bytes):
        self.buf = buf
        self.off = 0

    def take(self, nbytes: int) -> bytes:
        raw = self.buf[self.off:self.off + nbytes]
        self.off += nbytes + (-nbytes) % 8
        return raw

    def u64(self, n: int = 1) -> np.ndarray:
        return np.frombuffer(self.take(8 * n), np.uint64, n)


def _parse_swtable(r: _Reader, sat: int, total: int, items: int,
                   with_lengths: bool):
    """(starts, lengths) of gt's special-range table."""
    if items == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    maxval, dt = _SW_MAX[sat], _SW_DTYPE[sat]
    unit = np.dtype(dt).itemsize
    positions = np.frombuffer(r.take(unit * items), dt).astype(np.int64)
    lengths = (np.frombuffer(r.take(unit * items), dt).astype(np.int64) + 1
               if with_lengths else np.ones(items, np.int64))
    endidx = np.frombuffer(r.take(8 * (total // maxval + 1)),
                           np.uint64).astype(np.int64)
    page = np.searchsorted(endidx, np.arange(items), side="right")
    return positions + page * (maxval + 1), lengths


def read_esq(indexname: Path) -> list[bytes]:
    """The sequences of a DNA .esq (with its .ssp) as lower-case
    acgt bytes, wildcards as ``n``."""
    r = _Reader(Path(f"{indexname}.esq").read_bytes())
    if not r.take(1)[0]:
        raise NotImplementedError("32-bit .esq")
    version, sat, total, nseq, nfiles, lenfn = r.u64(6).astype(int).tolist()
    if version != 3 or sat not in _SW_MAX:
        raise NotImplementedError(f".esq version {version}, access {sat}")
    sci = r.u64(14).astype(np.int64).tolist()
    r.u64(3)                                    # min/max length, alphatype
    r.take(int(r.u64()[0]))                     # alphadef
    r.take(lenfn)                               # file names
    r.take(1)                                   # maxsubalphasize
    r.u64()                                     # numofallchars
    r.u64(2 * nfiles)                           # filelengthtab
    r.u64(4)                                    # character distribution
    words = np.frombuffer(r.take(8 * (2 + (total - 1) // 32)), np.uint64)
    raw = np.ascontiguousarray(words.view(np.uint8).reshape(-1, 8)[:, ::-1])
    raw = raw.reshape(-1)
    codes = np.stack([(raw >> 6) & 3, (raw >> 4) & 3, (raw >> 2) & 3,
                      raw & 3], axis=1).reshape(-1)[:total]
    text = np.frombuffer(b"acgt", np.uint8)[codes]
    starts, lens = _parse_swtable(r, sat, total, sci[6], True)
    for s, n in zip(starts.tolist(), lens.tolist()):
        text[s:s + n] = ord("n")
    seps = np.zeros(0, np.int64)
    if nseq > 1:
        buf = _Reader(Path(f"{indexname}.ssp").read_bytes())
        seps, _ = _parse_swtable(buf, _ssp_sat(total, nseq - 1), total,
                                 nseq - 1, False)
    bounds = np.concatenate([[-1], seps, [total]])
    return [text[a + 1:b].tobytes() for a, b in zip(bounds[:-1], bounds[1:])]


def _ssp_sat(total: int, numofseparators: int) -> int:
    """The access type gt picks for the separator table: the smallest
    table that fits."""
    best, best_size = 6, None
    for sat in (4, 5, 6):
        maxval = _SW_MAX[sat]
        size = np.dtype(_SW_DTYPE[sat]).itemsize * numofseparators + \
            8 * (total // maxval + 1)
        if best_size is None or size < best_size:
            best, best_size = sat, size
    return best


def shredder(seqs: list[bytes], minlength: int, maxlength: int,
             overlap: int, coverage: int, rng) -> list[bytes]:
    """gt shredder (src/extended/shredder.c generate_fragment): a
    fragment is minlength + rand(maxlength - minlength) long, the last
    of a sequence is cut short (never dropped), and the next starts
    fraglen - overlap on, at least 1; `coverage` passes."""
    out = []
    for _ in range(coverage):
        for seq in seqs:
            pos, n = 0, len(seq)
            while pos < n:
                frag = minlength if maxlength == minlength else \
                    minlength + int(rng.integers(0, maxlength - minlength + 1))
                last = pos + frag >= n
                if last:
                    frag = n - pos
                out.append(seq[pos:pos + frag])
                if last:
                    pos = n
                elif frag > overlap:
                    pos += frag - overlap
                else:
                    pos += 1
    return out


def make(params: dict, rng, workdir: Path) -> dict:
    """Shreds at1MB and writes the reads in `orders` orders drawn from
    the run's generator. Returns {"fastas": paths, "walks": the window's
    jobs in turn, each a list of indexes into fastas, "warm": the
    warm-up's, "read_bp": symbols a file}."""
    reads = shredder(read_esq(DATA / "idx"), params["minlength"],
                     params["maxlength"], params.get("overlap", 0),
                     params["coverage"],
                     np.random.default_rng(params["shred_seed"]))
    fastas = []
    for v in range(params["orders"]):
        path = workdir / f"reads{v}.fna"
        write_fasta(path, [(f"read{i}", reads[j]) for i, j in
                           enumerate(rng.permutation(len(reads)))])
        fastas.append(path)
    return {"fastas": fastas, **variant_walks(len(fastas)),
            "read_bp": sum(len(r) for r in reads)}

