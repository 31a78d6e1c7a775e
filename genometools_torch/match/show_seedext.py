"""`dev show_seedext` — re-display / re-align seed_extend match files.

The port's copy of ``genometools_tpu/match/show_seedext.py`` (JAX-free
host code; the port imports nothing of the reference package).

Capability equivalent of the reference tool (ref:
src/tools/gt_show_seedext.c over src/match/seed-extend-iter.c): parse a
match file produced by `seed_extend` (its `# Options:` header recovers
the run's indexes and parameters, `# Fields:` maps the columns), reload
the encseqs, and print the matches under a new `-outfmt` — including
full alignment re-rendering from a stored CIGAR, or re-alignment when
no trace information is present.
"""

from __future__ import annotations

import re
import sys
from dataclasses import dataclass, field

import numpy as np

_FIELD_KEYS = {
    "s. len": "s_len", "s. seqnum": "s_seqnum", "s. start": "s_start",
    "strand": "strand", "q. len": "q_len", "q. seqnum": "q_seqnum",
    "q. start": "q_start", "score": "score", "editdist": "editdist",
    "% identity": "identity", "cigar": "cigar", "cigarX": "cigar",
    "trace": "trace", "dtrace": "trace", "bit score": "bitscore",
    "evalue": "evalue", "s. seqlen": "s_seqlen", "q. seqlen": "q_seqlen",
    "seed. len": "seed_len", "seed. s": "seed_s", "seed. q": "seed_q",
    "s. id": "s_id", "q. id": "q_id",
}

_NUMERIC = {"s_len", "s_seqnum", "s_start", "q_len", "q_seqnum",
            "q_start", "score", "editdist", "s_seqlen", "q_seqlen",
            "seed_len", "seed_s", "seed_q"}


@dataclass
class MatchRow:
    values: dict = field(default_factory=dict)

    def __getattr__(self, k):
        try:
            return self.values[k]
        except KeyError:
            raise AttributeError(k) from None

    def get(self, k, default=None):
        return self.values.get(k, default)


@dataclass
class MatchFile:
    options: dict
    fields: list[str]
    rows: list[MatchRow]


def parse_options_line(line: str) -> dict:
    """'# Options: -ii at1MB -l 400 -outfmt cigar ...' -> dict; flag
    values collect until the next '-' token (outfmt is multi-valued)."""
    toks = line.split(":", 1)[1].split()
    out: dict = {}
    key = None
    for t in toks:
        if t.startswith("-") and not re.fullmatch(r"-\d+", t):
            key = t[1:]
            out[key] = []
        elif key is not None:
            out[key].append(t)
    return {k: (v[0] if len(v) == 1 else (v if v else True))
            for k, v in out.items()}


def parse_match_file(path: str) -> MatchFile:
    options: dict = {}
    fields: list[str] = []
    rows: list[MatchRow] = []
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if line.startswith("# Options:"):
                options = parse_options_line(line)
            elif line.startswith("# Fields:"):
                fields = [
                    _FIELD_KEYS.get(c.strip(), c.strip())
                    for c in line.split(":", 1)[1].split(",")]
            elif not line or line.startswith("#"):
                continue
            else:
                parts = line.split()
                if len(parts) < len(fields):
                    continue
                vals = {}
                for k, v in zip(fields, parts):
                    vals[k] = int(v) if k in _NUMERIC else v
                rows.append(MatchRow(vals))
    return MatchFile(options, fields, rows)


def cigar_to_ops(cig: str) -> list[tuple[str, int]]:
    """CIGAR / cigarX string -> display ops [('M'|'X'|'D'|'I', n)]."""
    ops = []
    for n, sym in re.findall(r"(\d+)([MIDX=])", cig):
        op = {"=": "M", "M": "M", "X": "X", "I": "I", "D": "D"}[sym]
        ops.append((op, int(n)))
    return ops


def show_seedext(path: str, outfmt: list[str], sortmatches: bool = False,
                 out=None) -> int:
    """Re-display a match file on ``out`` (default: sys.stdout at call
    time; the reference binds the sys.stdout of its import)."""
    from ..core.encseq import Encseq
    from .seed_extend import SeedExtendParams, _seq_codes
    from .seedext_display import (format_alignment, ops_to_cigar,
                                  seeded_alignment)
    out = sys.stdout if out is None else out
    mf = parse_match_file(path)
    ii = mf.options.get("ii")
    qii = mf.options.get("qii")
    if ii is None:
        print("show_seedext: no -ii recorded in match file",
              file=sys.stderr)
        return 1
    aenc = Encseq.load(ii)
    benc = Encseq.load(qii) if qii else aenc

    width = 60
    show_alignment = any(o == "alignment" or o.startswith("alignment=")
                         for o in outfmt)
    for o in outfmt:
        if o.startswith("alignment="):
            width = int(o.split("=")[1])
    want_cols = [o for o in outfmt
                 if o in ("cigar", "cigarX", "evalue", "bitscore",
                          "s.seqlen", "q.seqlen")]
    ka = None
    if "evalue" in want_cols or "bitscore" in want_cols:
        from .karlin_altschul import KarlinAltschulStat
        ka = KarlinAltschulStat.new_gapped(aenc.total_length,
                                           aenc.num_sequences)
    minidentity = int(mf.options.get("minidentity", 80))
    history = int(mf.options.get("history", 60))
    params = SeedExtendParams(minidentity=minidentity, history=history)

    rows = mf.rows
    if sortmatches:
        rows = sorted(rows, key=lambda r: (
            r.get("s_seqnum", 0), r.get("s_start", 0),
            r.get("q_seqnum", 0), r.get("q_start", 0)))

    new_fields = ["s. len", "s. seqnum", "s. start", "strand", "q. len",
                  "q. seqnum", "q. start", "score", "editdist",
                  "% identity"]
    for o in want_cols:
        new_fields.append({"cigar": "cigar", "cigarX": "cigarX",
                           "evalue": "evalue", "bitscore": "bit score",
                           "s.seqlen": "s. seqlen",
                           "q.seqlen": "q. seqlen"}[o])
    print("# Fields: " + ", ".join(new_fields), file=out)

    for r in rows:
        ops = None
        if r.get("cigar"):
            ops = cigar_to_ops(r.cigar)
        useq = _seq_codes(aenc, r.s_seqnum, False)
        vseq = _seq_codes(benc, r.q_seqnum, False)
        uo, vo = r.s_start, r.q_start
        if ops is None and r.get("seed_len") is not None \
                and r.strand == "F":
            from ..ops.greedy import PolishingInfo
            pol = PolishingInfo.new(
                float(params.errorpercentage), params.history)
            pmh, mad = params.greedy_params()
            ops, uo, _, vo, _, _ = seeded_alignment(
                useq, vseq, r.s_start, r.s_len, r.q_start, r.q_len,
                r.seed_s, r.seed_q, r.seed_len, pol, pmh, mad)
        if ops is None and (show_alignment or want_cols):
            # no trace info: optimal re-alignment of the match extents
            from .alignment import global_alignment
            u = useq[r.s_start:r.s_start + r.s_len]
            v = vseq[r.q_start:r.q_start + r.q_len] if r.strand == "F" \
                else _revcomp(vseq, r.q_start, r.q_len)
            ops = global_alignment(u, v).eops

        base = [str(r.s_len), str(r.s_seqnum), str(r.s_start), r.strand,
                str(r.q_len), str(r.q_seqnum), str(r.q_start),
                str(r.score), str(r.editdist), r.identity]
        for o in want_cols:
            if o == "cigar":
                base.append(ops_to_cigar(ops, distinguish=False))
            elif o == "cigarX":
                base.append(ops_to_cigar(ops, distinguish=True))
            elif o == "s.seqlen":
                base.append(str(int(aenc.seq_length(r.s_seqnum))))
            elif o == "q.seqlen":
                base.append(str(int(benc.seq_length(r.q_seqnum))))
            elif o in ("evalue", "bitscore"):
                from .karlin_altschul import evalue_for_match
                u = useq[uo:uo + r.s_len]
                v = vseq[vo:vo + r.q_len]
                mism = _count_mismatches(ops, u, v)
                ev, bs = evalue_for_match(
                    ka, int(benc.seq_length(r.q_seqnum)),
                    r.s_len + r.q_len, r.editdist, mism)
                base.append(f"{ev:.0e}" if o == "evalue"
                            else f"{bs:.1f}")
        print(" ".join(base), file=out)
        if show_alignment and ops is not None and r.strand == "F":
            u = useq[uo:uo + r.s_len] if r.get("cigar") else useq
            out.write(format_alignment(
                ops, useq[uo:uo + r.s_len],
                vseq[vo:vo + r.q_len], uo, vo, width=width))
    return 0


def _count_mismatches(ops, u: np.ndarray, v: np.ndarray) -> int:
    iu = iv = mism = 0
    for op, n in ops:
        if op in ("M", "X"):
            a = u[iu:iu + n]
            b = v[iv:iv + n]
            m = min(len(a), len(b))
            mism += int(((a[:m] != b[:m]) | (a[:m] >= 4)).sum())
            iu += n
            iv += n
        elif op == "D":
            iu += n
        else:
            iv += n
    return mism


def _revcomp(seq: np.ndarray, start: int, length: int) -> np.ndarray:
    sl = seq[start:start + length][::-1].copy()
    reg = sl < 4
    sl[reg] = 3 - sl[reg]
    return sl
