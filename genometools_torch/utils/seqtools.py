"""Sequence utility tools.

The port's copy of ``genometools_tpu/utils/seqtools.py`` (JAX-free
host code; the port imports nothing of the reference package).

Capability equivalents of the reference sequence tools
(ref: src/tools/gt_extractseq.c, gt_shredder.c, gt_sequniq.c,
gt_seqfilter.c, gt_simreads.c, gt_fingerprint.c, gt_splitfasta.c,
gt_convertseq.c, gt_seqtranslate.c, gt_seqmutate.c, gt_seqorder.c,
gt_fastq_sample.c and the engines they wrap).
"""

from __future__ import annotations

import hashlib
import re

import numpy as np

from ..core.seqio import SeqSet, read_seqfiles, write_fasta

_COMP = bytes.maketrans(b"acgtACGTnN", b"tgcaTGCAnN")


def revcomp_str(s: str) -> str:
    return s.encode()[::-1].translate(_COMP).decode()


# ---------------------------------------------------------------------------
# extractseq (ref: gt_extractseq.c: -frompos/-topos, -match on descriptions,
# -keys)
# ---------------------------------------------------------------------------

def extractseq(seqset: SeqSet, frompos: int | None = None,
               topos: int | None = None, match: str | None = None) -> SeqSet:
    out = SeqSet()
    if frompos is not None:
        # 1-based positions over the concatenation of all sequences; the
        # reference emits ONE descriptionless entry spanning sequence
        # boundaries (ref: gt_extractseq.c extractseq_pos)
        total = seqset.total_length
        if frompos > total or topos > total:
            raise ValueError(
                f"invalid position pair {frompos}-{topos} one value is "
                f"larger than sequence length {total}")
        buf = []
        acc = 0
        for seq in seqset.seqs:
            lo = frompos - 1 - acc
            hi = topos - acc
            acc += len(seq)
            if hi <= 0 or lo >= len(seq):
                continue
            buf.append(seq[max(lo, 0):min(hi, len(seq))])
        out.seqs.append(np.concatenate(buf) if buf
                        else np.zeros(0, np.uint8))
        out.descs.append("")
        return out
    rx = re.compile(match) if match else None
    for seq, desc in zip(seqset.seqs, seqset.descs):
        if rx is not None and not rx.search(desc):
            continue
        out.seqs.append(seq)
        out.descs.append(desc)
    return out


def extractseq_keys(seqset: SeqSet, keys_text: str):
    """-keys mode (ref: src/match/giextract.c gt_extractkeysfromfastafile).

    Key of a description = text between its first and second '|'.
    Keys-file lines are ``key [frompos topos]``; emission follows the
    sequence-file scan order, each matching query in key-sorted order.
    Yields (header, sequence-str) pairs.
    """
    queries: list[tuple[str, int | None, int | None]] = []
    for lno, line in enumerate(keys_text.splitlines(), 1):
        if not line.strip():
            continue
        parts = line.split()
        if len(parts) == 1:
            queries.append((parts[0], None, None))
        elif len(parts) == 3:
            try:
                frompos, topos = int(parts[1]), int(parts[2])
            except ValueError:
                raise ValueError(
                    f"line {lno} of keys file is corrupt: {line!r}")
            if frompos > topos:
                raise ValueError(
                    f"line {lno}: frompos > topos: {line!r}")
            queries.append((parts[0], frompos, topos))
        else:
            raise ValueError(f"line {lno} of keys file is corrupt: {line!r}")
    queries.sort(key=lambda q: (q[0], q[1] or 0, q[2] or 0))
    import bisect
    keysonly = [q[0] for q in queries]
    hits = 0
    for seq, desc in zip(seqset.seqs, seqset.descs):
        if hits >= len(queries):
            break
        p1 = desc.find("|")
        p2 = desc.find("|", p1 + 1) if p1 >= 0 else -1
        if p1 < 0 or p2 < 0:
            raise ValueError(f'Cannot find key in description "{desc}"')
        key = desc[p1 + 1:p2]
        i = bisect.bisect_left(keysonly, key)
        while i < len(queries) and keysonly[i] == key:
            _, frompos, topos = queries[i]
            s = seq.tobytes().decode("latin-1")
            if frompos is None:
                yield desc, s
            else:
                yield (f"{key} {frompos} {topos} {desc}",
                       s[frompos - 1:topos])
            hits += 1
            i += 1


# ---------------------------------------------------------------------------
# shredder (ref: gt_shredder.c: cut sequences into overlapping fragments)
# ---------------------------------------------------------------------------

def shredder(seqset: SeqSet, minlength: int = 300, maxlength: int = 700,
             overlap: int = 0, coverage: int = 1, seed: int = 0,
             sample_probability: float = 1.0,
             clip_desc: bool = False) -> SeqSet:
    """ref: src/extended/shredder.c generate_fragment — fraglen is
    min + rand(max-min); the LAST fragment of each sequence is truncated
    (never dropped); otherwise advance fraglen-overlap, at least 1."""
    rng = np.random.default_rng(seed)
    out = SeqSet()
    for _ in range(coverage):
        for seq, desc in zip(seqset.seqs, seqset.descs):
            pos = 0
            n = len(seq)
            while pos < n:
                frag = minlength if maxlength == minlength else \
                    minlength + int(rng.integers(0, maxlength - minlength + 1))
                last = pos + frag >= n
                if last:
                    frag = n - pos
                piece = seq[pos:pos + frag]
                if clip_desc:
                    d = (f"{desc.split(' ')[0]}_{pos}_{frag}"
                         f" [shreddered fragment]")
                else:
                    d = desc + " [shreddered fragment]"
                if sample_probability >= 1.0 or \
                        rng.random() <= sample_probability:
                    out.seqs.append(piece)
                    out.descs.append(d)
                if last:
                    pos = n
                elif frag > overlap:
                    pos += frag - overlap
                else:
                    pos += 1
    return out


# ---------------------------------------------------------------------------
# sequniq (ref: gt_sequniq.c: remove exact duplicates, optionally
# reverse-complement duplicates)
# ---------------------------------------------------------------------------

def sequniq(seqset: SeqSet, rev: bool = False) -> tuple[SeqSet, int]:
    """Returns (kept set, number of duplicates removed).
    ref: gt_sequniq.c + extended/md5set.c gt_md5set_add_sequence — the
    reverse complement is only probed when it differs from the forward
    sequence (palindromes are always kept)."""
    seen = set()
    out = SeqSet()
    dups = 0
    for seq, desc in zip(seqset.seqs, seqset.descs):
        key = seq.tobytes().upper()
        if key in seen:
            dups += 1
            continue
        if rev:
            rckey = key[::-1].translate(_COMP)
            if rckey != key and rckey in seen:
                dups += 1
                continue
        seen.add(key)
        out.seqs.append(seq)
        out.descs.append(desc)
    return out, dups


# ---------------------------------------------------------------------------
# seqfilter (ref: gt_seqfilter.c: -minlength -maxlength -maxseqnum
# -sample -step)
# ---------------------------------------------------------------------------

def _has_wildcards(seq: np.ndarray, alpha) -> bool:
    """ref: gt_bioseq_seq_has_wildcards — wildcard per the guessed
    alphabet (DNA: IUPAC ambiguity codes; protein: X/U/B/Z/J/O/*/-)."""
    from ..core.chardef import WILDCARD
    return bool((alpha.encode(seq) == WILDCARD).any())


def seqfilter(seqset: SeqSet, minlength: int | None = None,
              maxlength: int | None = None, maxseqnum: int | None = None,
              step: int = 1, sample_prob: float = 1.0,
              nowildcards: bool = False,
              seed: int = 0) -> tuple[SeqSet, int, int]:
    """Returns (kept set, filtered count, total count).
    ref: gt_seqfilter.c runner — -step keeps every step-th sequence
    (the step-th of each cycle), -maxseqnum stops considering further
    sequences (they count as filtered)."""
    rng = np.random.default_rng(seed)
    out = SeqSet()
    passed = 0
    filtered = 0
    total = len(seqset.seqs)
    steps = 0
    alpha = None
    if nowildcards:
        from ..core.alphabet import guess_alphabet
        alpha = guess_alphabet(
            b"".join(s.tobytes() for s in seqset.seqs[:50]))
    for i, (seq, desc) in enumerate(zip(seqset.seqs, seqset.descs)):
        if maxseqnum is not None and passed >= maxseqnum:
            filtered += total - i
            break
        ok = (step == 1 or steps + 1 == step) and \
            (sample_prob >= 1.0 or rng.random() <= sample_prob) and \
            (minlength is None or len(seq) >= minlength) and \
            (maxlength is None or len(seq) <= maxlength) and \
            (not nowildcards or not _has_wildcards(seq, alpha))
        if ok:
            out.seqs.append(seq)
            out.descs.append(desc)
            passed += 1
        else:
            filtered += 1
        steps = 0 if steps + 1 == step else steps + 1
    return out, filtered, total


# ---------------------------------------------------------------------------
# simreads (ref: gt_simreads.c: sample error-free reads from a sequence)
# ---------------------------------------------------------------------------

def simreads(seqset: SeqSet, num: int = 100, length: int = 100,
             reverse: bool = True, seed: int = 0,
             coverage: float | None = None) -> SeqSet:
    rng = np.random.default_rng(seed)
    lens = np.array([len(s) for s in seqset.seqs], np.int64)
    ok = np.nonzero(lens >= length)[0]
    assert ok.size, "no sequence long enough"
    weights = lens[ok] / lens[ok].sum()
    if coverage is not None:
        num = int(coverage * lens[ok].sum() / length)
    out = SeqSet()
    for r in range(num):
        si = int(rng.choice(ok, p=weights))
        seq = seqset.seqs[si]
        start = int(rng.integers(0, len(seq) - length + 1))
        read = seq[start:start + length]
        if reverse and rng.random() < 0.5:
            read = np.frombuffer(
                read.tobytes()[::-1].translate(_COMP), np.uint8)
        out.seqs.append(read)
        out.descs.append(f"read_{r}")
    return out


# ---------------------------------------------------------------------------
# fingerprint (ref: gt_fingerprint.c: md5 of upper-cased sequence)
# ---------------------------------------------------------------------------

def fingerprints(seqset: SeqSet) -> list[str]:
    return [hashlib.md5(s.tobytes().upper()).hexdigest() for s in seqset.seqs]


# ---------------------------------------------------------------------------
# splitfasta (ref: gt_splitfasta.c: split into numfiles parts or by size)
# ---------------------------------------------------------------------------

def splitfasta(seqset: SeqSet, numfiles: int) -> list[SeqSet]:
    total = seqset.total_length
    target = total / numfiles
    parts = [SeqSet() for _ in range(numfiles)]
    cur = 0
    acc = 0
    for seq, desc in zip(seqset.seqs, seqset.descs):
        if acc >= target * (cur + 1) and cur < numfiles - 1:
            cur += 1
        parts[cur].seqs.append(seq)
        parts[cur].descs.append(desc)
        acc += len(seq)
    return parts


# ---------------------------------------------------------------------------
# seqmutate (ref: gt_seqmutate.c / gt mutate: random point mutations)
# ---------------------------------------------------------------------------

def mutate(seqset: SeqSet, rate_percent: float = 1.0, seed: int = 0) -> SeqSet:
    rng = np.random.default_rng(seed)
    chars = np.frombuffer(b"acgt", np.uint8)
    out = SeqSet()
    for seq, desc in zip(seqset.seqs, seqset.descs):
        s = seq.copy()
        hit = rng.random(len(s)) < rate_percent / 100.0
        s[hit] = chars[rng.integers(0, 4, int(hit.sum()))]
        out.seqs.append(s)
        out.descs.append(desc)
    return out


# ---------------------------------------------------------------------------
# translation (ref: gt_seqtranslate.c, src/core/codon_iterator*.c,
# src/core/trans_table.c — standard translation table 1)
# ---------------------------------------------------------------------------

_CODON_TABLE_1 = {}


def _build_codon_table():
    bases = "tcag"
    aas = ("FFLLSSSSYY**CC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRR"
           "VVVVAAAADDEEGGGG")
    i = 0
    for b1 in bases:
        for b2 in bases:
            for b3 in bases:
                _CODON_TABLE_1[b1 + b2 + b3] = aas[i]
                i += 1


_build_codon_table()


def translate_dna(seq: str, frame: int = 0) -> str:
    """Translate one frame (0/1/2); unknown codons -> 'X'
    (ref: gt_translator_translate)."""
    s = seq.lower().replace("u", "t")
    out = []
    for i in range(frame, len(s) - 2, 3):
        out.append(_CODON_TABLE_1.get(s[i:i + 3], "X"))
    return "".join(out)


def translate_all_frames(seq: str) -> list[str]:
    """6-frame translation (3 forward + 3 reverse complement)."""
    rc = revcomp_str(seq)
    return [translate_dna(seq, f) for f in range(3)] + \
        [translate_dna(rc, f) for f in range(3)]


# ---------------------------------------------------------------------------
# ORF finding (ref: src/extended/orf_iterator.c, gt_orffinder.c)
# ---------------------------------------------------------------------------

def find_orfs(seq: str, minlen: int = 30, start_codons=("atg",),
              stop_codons=("taa", "tag", "tga")) -> list[tuple[int, int, int]]:
    """ORFs as (start, end_exclusive, frame 0..5); coordinates on the
    forward strand for frames 0-2, reverse strand local for 3-5."""
    res = []
    strands = [seq.lower(), revcomp_str(seq).lower()]
    for si, s in enumerate(strands):
        for f in range(3):
            i = f
            start = None
            while i + 3 <= len(s):
                codon = s[i:i + 3]
                if start is None and codon in start_codons:
                    start = i
                elif start is not None and codon in stop_codons:
                    if i + 3 - start >= minlen:
                        res.append((start, i + 3, si * 3 + f))
                    start = None
                i += 3
    return res
