"""Homopolymer error correction (gt hop).

The port's copy of ``genometools_tpu/assembly/hop.py`` (JAX-free
host code; the port imports nothing of the reference package).

Capability equivalent of the reference HOP machinery
(ref: src/extended/hpol_processor.c, aligned_segment.c,
aligned_segments_pile.c, tools/gt_hop.c): walk the cognate (reference)
sequence, and at every homopolymer of length >= hmin adjust the
homopolymer length of the piled-up mapped reads to the reference
length, subject to the consensus/quality thresholds of the selected
correction mode.

Validated against testdata/hop/hop_{aggressive,moderate,conservative,
hmin4,read-hmin3}.fastq and the 10reads variants.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..utils.seqtools import revcomp_str

_UNDEF = "\x00"
_PHRED = 33


@dataclass
class HopParams:
    hmin: int = 3
    read_hmin: int = 2
    qmax: int = 120
    altmax: float = 0.8
    refmin: float = 0.1  # -cogmin
    mapqmin: int = 21
    covmin: int = 1
    clenmax: int | None = None
    allow_partial: bool = False
    allow_multiple: bool = False

    @classmethod
    def aggressive(cls):
        """ref: gt_hop.c:339."""
        return cls(hmin=3, read_hmin=1, qmax=120, altmax=1.0, refmin=0.0,
                   mapqmin=0, covmin=1, clenmax=None, allow_multiple=True)

    @classmethod
    def moderate(cls):
        return cls(hmin=3, read_hmin=1, qmax=120, altmax=0.99, refmin=0.0,
                   mapqmin=10, covmin=1, clenmax=None, allow_multiple=True)

    @classmethod
    def conservative(cls):
        return cls(hmin=3, read_hmin=2, qmax=120, altmax=0.8, refmin=0.1,
                   mapqmin=21, covmin=1, clenmax=None,
                   allow_multiple=False)


class AlignedSegment:
    """Gapped alignment columns of one mapped read
    (ref: aligned_segment.c): s = read row ('-' on deletions), q =
    quality row (undef on deletions), r = reference row ('-' on
    insertions, '?' where the ref char is unknown)."""

    def __init__(self, qname: str, flag: int, refstart0: int, mapq: int,
                 cigar_ops, seq: str, qual: str):
        self.desc = qname
        self.mapq = mapq
        self.reverse = bool(flag & 16)
        self.edited = False
        self.has_indels = False
        s, q, r = [], [], []
        i = 0
        ref_len = 0
        lead = True
        soft_before = soft_after = 0
        for n, op in cigar_ops:
            if op in "M=X":
                s.append(seq[i:i + n])
                q.append(qual[i:i + n])
                r.append("?" * n)
                i += n
                ref_len += n
                lead = False
            elif op == "S":
                # soft clips extend the refregion span
                # (ref: aligned_segment.c:100 'S' case)
                if lead:
                    soft_before = n
                else:
                    soft_after += n
                s.append(seq[i:i + n])
                q.append(qual[i:i + n])
                r.append("?" * n)
                i += n
                lead = False
            elif op == "I":
                s.append(seq[i:i + n])
                q.append(qual[i:i + n])
                r.append("-" * n)
                i += n
                self.has_indels = True
                lead = False
            elif op in "DN":
                s.append("-" * n)
                q.append(_UNDEF * n)
                r.append("?" * n)
                ref_len += n
                self.has_indels = True
                lead = False
            # H and P are ignored
        self.s = list("".join(s))
        self.q = list("".join(q))
        self.r = "".join(r)
        self.r_left = refstart0 - soft_before
        # the reference's refregion endpos is the EXCLUSIVE end
        # (ref: sam_alignment.c:109 rightmost_pos via bam_calend)
        self.r_right = refstart0 + ref_len + soft_after

    def offset_for_refpos(self, refpos: int) -> int | None:
        """Column of ref position refpos (ref: aligned_segment.c:276)."""
        if refpos < self.r_left or refpos > self.r_right:
            return None
        r_offset = refpos - self.r_left
        pos = 0
        ungapped = 0
        while ungapped < r_offset:
            if self.r[pos] != "-":
                ungapped += 1
            pos += 1
        return pos

    def output(self) -> tuple[str, str]:
        """Ungapped (seq, qual), restored to original read orientation
        (ref: hpol_processor.c gt_hpol_processor_output_segment)."""
        seq = "".join(c for c in self.s if c != "-")
        qual = "".join(c for c, sc in zip(self.q, self.s) if sc != "-")
        if self.reverse:
            seq = revcomp_str(seq)
            qual = qual[::-1]
        return seq, qual


def _hlen_forwards(s, q, pos, maxpos, c):
    """(run_length, raw_qual_sum, gaps) of the c-run at pos
    (ref: hpol_processor.c determine_hlen_forwards)."""
    s_hlen = q_sum = gaps = 0
    while pos <= maxpos:
        if s[pos] == c:
            s_hlen += 1
            q_sum += ord(q[pos])
        elif s[pos] == "-":
            gaps += 1
        else:
            break
        pos += 1
    return s_hlen, q_sum, gaps


def _subst_from_right(s, q, left, right, length, old, new, qual):
    for pos in range(right, left - 1, -1):
        if length == 0:
            break
        if s[pos] == old:
            s[pos] = new
            q[pos] = qual
            length -= 1


def _adjust_segment(as_, c, r_hstart, r_hlen, p: HopParams) -> bool:
    """ref: hpol_processor.c:617 adjust_hlen_of_a_segment."""
    left = as_.offset_for_refpos(r_hstart)
    right = as_.offset_for_refpos(r_hstart + r_hlen)
    if left is None or left == 0 or right is None or right == len(as_.s):
        return False
    right -= 1
    s_hlen, q_sum, s_free = _hlen_forwards(as_.s, as_.q, left, right, c)
    if s_hlen == 0 or s_hlen < p.read_hmin:
        return False
    q_ave = (q_sum - _PHRED * s_hlen) / s_hlen
    clenmax = p.clenmax if p.clenmax is not None else float("inf")
    if s_hlen < r_hlen:
        diff = r_hlen - s_hlen
        if s_free > 0 and diff <= clenmax and q_ave <= p.qmax and \
                (s_free >= diff or p.allow_partial) and \
                (not as_.edited or p.allow_multiple):
            as_.edited = True
            _subst_from_right(as_.s, as_.q, left, right,
                              min(s_free, diff), "-", c,
                              chr(q_sum // s_hlen))
            return True
    elif s_hlen > r_hlen:
        diff = s_hlen - r_hlen
        if diff <= clenmax and q_ave <= p.qmax and \
                (not as_.edited or p.allow_multiple):
            as_.edited = True
            _subst_from_right(as_.s, as_.q, left, right, diff, c, "-",
                              _UNDEF)
            return True
    return False


class _Pile:
    """Sweep over position-sorted segments
    (ref: aligned_segments_pile.c): the pile holds the segments whose
    refregion contains the current position."""

    def __init__(self, segments):
        self.stream = iter(segments)
        self.next_as = None
        self.exhausted = False
        self.pile: list[AlignedSegment] = []
        self.done: list[AlignedSegment] = []

    def move_over(self, position: int) -> None:
        keep = []
        for as_ in self.pile:
            if as_.r_right < position:
                self.done.append(as_)
            else:
                keep.append(as_)
        self.pile = keep
        while True:
            if self.next_as is None and not self.exhausted:
                self.next_as = next(self.stream, None)
                if self.next_as is None:
                    self.exhausted = True
            if self.next_as is None:
                break
            if self.next_as.r_right < position:
                self.done.append(self.next_as)  # skipped
                self.next_as = None
            elif self.next_as.r_left <= position:
                self.pile.append(self.next_as)
                self.next_as = None
            else:
                break

    def flush(self):
        self.done.extend(self.pile)
        self.pile = []
        if self.next_as is not None:
            self.done.append(self.next_as)
            self.next_as = None
        for as_ in self.stream:
            self.done.append(as_)


def _parse_cigar(cigar: str):
    out = []
    num = ""
    for ch in cigar:
        if ch.isdigit():
            num += ch
        else:
            out.append((int(num), ch))
            num = ""
    return out


def alignments_from_sam(sam_text: str):
    """(qname, flag, rname, pos1, mapq, cigar, seq, qual) records."""
    out = []
    for line in sam_text.splitlines():
        if not line or line.startswith("@"):
            continue
        f = line.split("\t")
        if len(f) < 11:
            continue
        out.append((f[0], int(f[1]), f[2], int(f[3]), int(f[4]), f[5],
                    f[9], f[10]))
    return out


def alignments_from_bam(path: str):
    """Minimal BAM reader (BGZF = multi-member gzip; ref: the BAM spec
    the reference accesses through vendored samtools)."""
    import gzip
    import struct
    data = gzip.decompress(open(path, "rb").read())
    assert data[:4] == b"BAM\x01", "not a BAM file"
    off = 4
    l_text, = struct.unpack_from("<i", data, off)
    off += 4 + l_text
    n_ref, = struct.unpack_from("<i", data, off)
    off += 4
    refs = []
    for _ in range(n_ref):
        l_name, = struct.unpack_from("<i", data, off)
        off += 4
        refs.append(data[off:off + l_name - 1].decode())
        off += l_name + 4
    ops = "MIDNSHP=X"
    seq_chars = "=ACMGRSVTWYHKDBN"
    out = []
    while off < len(data):
        block_size, = struct.unpack_from("<i", data, off)
        off += 4
        end = off + block_size
        (ref_id, pos, l_read_name, mapq, _bin, n_cigar, flag,
         l_seq, _nref, _npos, _tlen) = struct.unpack_from(
            "<iiBBHHHiiii", data, off)
        p = off + 32
        qname = data[p:p + l_read_name - 1].decode()
        p += l_read_name
        cigar = ""
        for _ in range(n_cigar):
            v, = struct.unpack_from("<I", data, p)
            p += 4
            cigar += f"{v >> 4}{ops[v & 0xF]}"
        seq = "".join(seq_chars[(data[p + (i >> 1)] >> (4 if i % 2 == 0
                                                        else 0)) & 0xF]
                      for i in range(l_seq))
        p += (l_seq + 1) // 2
        qual = "".join(chr(q + 33) for q in data[p:p + l_seq])
        rname = refs[ref_id] if ref_id >= 0 else "*"
        out.append((qname, flag, rname, pos + 1, mapq,
                    cigar if cigar else "*", seq, qual))
        off = end
    return out


def hop_correct(ref_seqs: list[str], alignments, params: HopParams
                ) -> dict[str, AlignedSegment]:
    """Run homopolymer correction; returns read-id -> corrected segment
    (ref: hpol_processor.c gt_hpol_processor_run).  ``alignments`` is a
    SAM text or a record list from alignments_from_sam/bam."""
    if isinstance(alignments, str):
        alignments = alignments_from_sam(alignments)
    # reference sequence names -> global encseq-like positions
    names = []
    offsets = {}
    off = 0
    for desc, seq in ref_seqs:
        name = desc.split()[0]
        names.append(name)
        offsets[name] = off
        off += len(seq) + 1  # separator
    segments = []
    unmapped = []
    for qname, flag, rname, pos, mapq, cigar, seq, qual in alignments:
        seq = seq.lower()
        if flag & 4:
            if not flag & 256:
                as_ = AlignedSegment(qname, flag, 0, mapq, [], seq, qual)
                as_.r_left = as_.r_right = None
                as_.s = list(seq)
                as_.q = list(qual)
                unmapped.append(as_)
            continue
        segments.append(AlignedSegment(qname, flag,
                                       offsets[rname] + pos - 1, mapq,
                                       _parse_cigar(cigar), seq, qual))
    pile = _Pile(segments)
    # walk homopolymers of the cognate sequence
    for desc, seq in ref_seqs:
        base = offsets[desc.split()[0]]
        n = len(seq)
        i = 0
        while i < n:
            j = i
            while j + 1 < n and seq[j + 1] == seq[i]:
                j += 1
            hlen = j - i + 1
            if hlen >= params.hmin:
                _process_hpol_end(pile, seq[i].lower(), base + j, hlen,
                                  params)
            i = j + 1
    pile.flush()
    # collect results keyed by read id; an edited version replaces an
    # unedited one (ref: add_segment_to_hashmap)
    result: dict[str, AlignedSegment] = {}
    for as_ in pile.done + unmapped:
        stored = result.get(as_.desc)
        if stored is None:
            result[as_.desc] = as_
        elif not stored.edited and as_.edited:
            result[as_.desc] = as_
    return result


def _process_hpol_end(pile: _Pile, c: str, endpos: int, hlen: int,
                      params: HopParams) -> None:
    """ref: hpol_processor.c:806 process_hpol_end."""
    pile.move_over(endpos + 1)
    if len(pile.pile) < params.covmin:
        return
    r_hstart = endpos + 1 - hlen
    # alternative consensus over segments covering the whole hpol
    s_hlen_max = hlen * 2
    occ = [0] * (s_hlen_max + 1)
    piled = 0
    for as_ in pile.pile:
        left = as_.offset_for_refpos(r_hstart)
        right = as_.offset_for_refpos(r_hstart + hlen)
        if left is None or right is None:
            continue
        piled += 1
        s_hlen, _, _ = _hlen_forwards(as_.s, as_.q, left, right - 1, c)
        occ[min(s_hlen, s_hlen_max)] += 1
    r_supp = occ[hlen]
    a_supp = occ[0]
    for i in range(s_hlen_max + 1):
        if i != hlen and occ[i] > a_supp:
            a_supp = occ[i]
    a_supp_max = int(params.altmax * piled)
    r_supp_min = int(params.refmin * piled)
    if not (r_supp < piled and r_supp >= r_supp_min and
            a_supp <= a_supp_max):
        return
    for as_ in pile.pile:
        if as_.has_indels and as_.mapq >= params.mapqmin:
            _adjust_segment(as_, c, r_hstart, hlen, params)


def hop_output(result: dict[str, AlignedSegment], reads_descs: list[str],
               reads: list[tuple[str, str]]) -> str:
    """Render corrected reads in input-file order as FASTQ
    (ref: gt_hpol_processor_output_sorted_segments)."""
    import warnings
    out = []
    for desc in reads_descs:
        key = desc.split()[0] if desc else desc
        as_ = result.get(key)
        if as_ is None:
            warnings.warn(f"ID not found: {key}")
            continue
        seq, qual = as_.output()
        out.append(f"@{desc}\n{seq}\n+\n{qual}")
    return "\n".join(out) + ("\n" if out else "")
