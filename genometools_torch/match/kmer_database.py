"""K-mer database: merged, position-annotated k-mer store.

The port's copy of ``genometools_tpu/match/kmer_database.py`` (JAX-free
host code; the port imports nothing of the reference package).

Capability equivalent of the reference GtKmerDatabase
(ref: src/extended/kmer_database.c) as driven by `gt dev kmer_database`
(ref: src/tools/gt_kmer_database.c): k-mers of an encoded sequence set
are accumulated in sorted buffers, merged into one database keyed by
code with per-occurrence (seqnum, startpos) lists, optionally with a
per-interval id compression and a cutoff on occurrence counts.

TPU-first redesign: the reference merges per-buffer sorted linked
blocks; here one vectorized sort/segment pass builds the same store —
the merge() of two databases is a numpy merge by code, and the
`interval id` compaction becomes the (codes, offsets) CSR layout.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core.chardef import is_special
from ..core.encseq import Encseq
from ..ops.kmer import kmer_codes_np


@dataclass
class KmerDatabase:
    kmersize: int
    codes: np.ndarray      # int64[nkeys], sorted distinct codes
    offsets: np.ndarray    # int64[nkeys+1] CSR into seqnums/positions
    seqnums: np.ndarray    # int64[nocc]
    positions: np.ndarray  # int64[nocc]

    @property
    def num_keys(self) -> int:
        return int(self.codes.size)

    @property
    def num_occurrences(self) -> int:
        return int(self.seqnums.size)

    @classmethod
    def from_encseq(cls, enc: Encseq, k: int,
                    cutoff: int | None = None) -> "KmerDatabase":
        """All valid (special-free) k-mers of every sequence; with
        `cutoff`, codes occurring more often keep only the first
        `cutoff` occurrences (ref: gt_kmer_database_set_cutoff)."""
        codes_all, seq_all, pos_all = [], [], []
        for s in range(enc.num_sequences):
            lo = int(enc.seq_startpos(s))
            hi = int(enc.seq_endpos(s))
            seq = enc.codes[lo:hi + 1]
            if seq.size < k:
                continue
            code, valid = kmer_codes_np(seq, k)
            p = np.flatnonzero(valid)
            codes_all.append(code[p])
            seq_all.append(np.full(p.size, s, np.int64))
            pos_all.append(p)
        if not codes_all:
            z = np.zeros(0, np.int64)
            return cls(k, z, np.zeros(1, np.int64), z, z)
        code = np.concatenate(codes_all)
        seqn = np.concatenate(seq_all)
        pos = np.concatenate(pos_all)
        order = np.lexsort((pos, seqn, code))
        code, seqn, pos = code[order], seqn[order], pos[order]
        if cutoff is not None:
            newk = np.concatenate([[True], code[1:] != code[:-1]])
            run = np.arange(code.size) - \
                np.maximum.accumulate(np.where(newk,
                                               np.arange(code.size), 0))
            keep = run < cutoff
            code, seqn, pos = code[keep], seqn[keep], pos[keep]
        newk = np.concatenate([[True], code[1:] != code[:-1]]) \
            if code.size else np.zeros(0, bool)
        starts = np.flatnonzero(newk)
        offsets = np.append(starts, code.size).astype(np.int64)
        return cls(k, code[starts], offsets, seqn, pos)

    def occurrences(self, code: int):
        """(seqnums, positions) of one k-mer code."""
        i = int(np.searchsorted(self.codes, code))
        if i >= self.num_keys or self.codes[i] != code:
            return (np.zeros(0, np.int64), np.zeros(0, np.int64))
        lo, hi = int(self.offsets[i]), int(self.offsets[i + 1])
        return self.seqnums[lo:hi], self.positions[lo:hi]

    def merge(self, other: "KmerDatabase") -> "KmerDatabase":
        """ref: gt_kmer_database_add_* buffer merging — one merge by
        code, occurrence lists concatenated in (self, other) order."""
        assert self.kmersize == other.kmersize
        code = np.concatenate([
            np.repeat(self.codes,
                      np.diff(self.offsets)) if self.num_keys
            else np.zeros(0, np.int64),
            np.repeat(other.codes,
                      np.diff(other.offsets)) if other.num_keys
            else np.zeros(0, np.int64)])
        src = np.concatenate([np.zeros(self.num_occurrences, np.int64),
                              np.ones(other.num_occurrences, np.int64)])
        seqn = np.concatenate([self.seqnums, other.seqnums])
        pos = np.concatenate([self.positions, other.positions])
        idx = np.concatenate([np.arange(self.num_occurrences),
                              np.arange(other.num_occurrences)])
        order = np.lexsort((idx, src, code))
        code, seqn, pos = code[order], seqn[order], pos[order]
        newk = np.concatenate([[True], code[1:] != code[:-1]]) \
            if code.size else np.zeros(0, bool)
        starts = np.flatnonzero(newk)
        offsets = np.append(starts, code.size).astype(np.int64)
        return KmerDatabase(self.kmersize, code[starts], offsets,
                            seqn, pos)

    def check_consistency(self) -> bool:
        """ref: gt_kmer_database_check_consistency — codes strictly
        ascending, offsets monotone and covering."""
        if self.num_keys == 0:
            return self.offsets.tolist() == [0]
        return bool((np.diff(self.codes) > 0).all()
                    and (np.diff(self.offsets) > 0).all()
                    and self.offsets[0] == 0
                    and self.offsets[-1] == self.num_occurrences)
