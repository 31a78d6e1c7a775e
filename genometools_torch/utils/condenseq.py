"""Condenseq: redundancy-compressed sequence sets.

The port's copy of ``genometools_tpu/utils/condenseq.py`` (JAX-free
host code; the port imports nothing of the reference package).

Capability equivalent of `gt condenseq` (ref: src/extended/condenseq*.c):
a sequence set is stored as a set of *unique* ranges plus *links* —
ranges represented as an edit script against a unique range. Search and
extraction run against the compressed form.

Redesign: the compressor seeds with k-mer anchors against the already-
unique prefix of the store (the same join machinery as seed_extend) and
encodes linked ranges as (unique_id, offset, CIGAR-style edit script).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..core.seqio import SeqSet
from ..match.alignment import global_alignment
from ..ops.kmer import kmer_codes_np


@dataclass
class Link:
    unique_id: int
    offset: int               # start in the unique sequence
    eops: list                # alignment ops reconstructing this seq
    target: np.ndarray        # residues differing (for mismatch/insert ops)


@dataclass
class CondensedSeqSet:
    uniques: list = field(default_factory=list)     # uint8 arrays
    entries: list = field(default_factory=list)     # ("u", idx)|("l", Link)
    descs: list = field(default_factory=list)

    @property
    def num_sequences(self) -> int:
        return len(self.entries)

    def compressed_size(self) -> int:
        usize = sum(len(u) for u in self.uniques)
        lsize = sum(len(e[1].eops) * 3 + len(e[1].target)
                    for e in self.entries if e[0] == "l")
        return usize + lsize

    # -- extraction --------------------------------------------------------
    def extract(self, i: int) -> np.ndarray:
        kind, val = self.entries[i]
        if kind == "u":
            return self.uniques[val]
        link: Link = val
        ref = self.uniques[link.unique_id]
        out = []
        ri = link.offset
        ti = 0
        for op, c in link.eops:
            if op == "=":
                out.append(ref[ri:ri + c])
                ri += c
            elif op == "X" or op == "I":
                out.append(link.target[ti:ti + c])
                ti += c
                if op == "X":
                    ri += c
            elif op == "D":
                ri += c
        return np.concatenate(out) if out else np.zeros(0, np.uint8)


def compress(seqset: SeqSet, kmersize: int = 16,
             min_align_identity: float = 80.0) -> CondensedSeqSet:
    """Greedy compressor: each sequence either links to a previous unique
    (if a k-mer anchor leads to an alignment above the identity cutoff)
    or becomes a new unique."""
    store = CondensedSeqSet(descs=list(seqset.descs))
    anchor_codes: list[np.ndarray] = []   # per unique, sorted kmer codes

    for seq in seqset.seqs:
        codes = seq.copy()
        from ..core.alphabet import dna_alphabet
        enc = dna_alphabet().encode(codes)
        linked = False
        if enc.size >= kmersize:
            qcode, qvalid = kmer_codes_np(enc, kmersize)
            for uid, acodes in enumerate(anchor_codes):
                hit = np.isin(qcode[qvalid], acodes)
                if hit.any():
                    ref = store.uniques[uid]
                    if abs(len(ref) - enc.size) <= max(len(ref), enc.size):
                        r = global_alignment(ref, enc, 0, -1, -1)
                        m, mm, ind = r.counts(ref, enc)
                        total = m + mm + ind
                        if total and 100.0 * m / total >= min_align_identity:
                            link = _make_link(uid, ref, enc, r)
                            store.entries.append(("l", link))
                            linked = True
                            break
        if not linked:
            uid = len(store.uniques)
            store.uniques.append(enc)
            store.entries.append(("u", uid))
            if enc.size >= kmersize:
                c, v = kmer_codes_np(enc, kmersize)
                anchor_codes.append(np.unique(c[v]))
            else:
                anchor_codes.append(np.zeros(0, np.int64))
    return store


def _make_link(uid: int, ref: np.ndarray, enc: np.ndarray, r) -> Link:
    eops = []
    target = []
    ri = vi = 0
    for op, c in r.eops:
        if op == "M":
            run_op = None
            run = 0
            for _ in range(c):
                cur = "=" if (ref[ri] == enc[vi] and ref[ri] < 4) else "X"
                if cur == run_op:
                    run += 1
                else:
                    if run_op:
                        eops.append((run_op, run))
                    run_op, run = cur, 1
                if cur == "X":
                    target.append(enc[vi])
                ri += 1
                vi += 1
            if run_op:
                eops.append((run_op, run))
        elif op == "D":
            eops.append(("D", c))
            ri += c
        else:
            eops.append(("I", c))
            target.extend(enc[vi:vi + c])
            vi += c
    return Link(uid, 0, eops, np.asarray(target, np.uint8))


# ---------------------------------------------------------------------------
# persistence + info + search (ref: src/tools/gt_condenseq_{compress,
# extract,info,search}.c)
# ---------------------------------------------------------------------------

def save(store: CondensedSeqSet, indexname: str) -> None:
    import json
    arrays = {}
    meta = {"descs": store.descs, "entries": [], "nuniques":
            len(store.uniques)}
    for i, u in enumerate(store.uniques):
        arrays[f"u{i}"] = u
    for j, (kind, val) in enumerate(store.entries):
        if kind == "u":
            meta["entries"].append(["u", val])
        else:
            meta["entries"].append(
                ["l", val.unique_id, val.offset,
                 [[op, int(c)] for op, c in val.eops]])
            arrays[f"t{j}"] = val.target
    np.savez_compressed(indexname + ".cse", **arrays)
    with open(indexname + ".cse.json", "w") as f:
        json.dump(meta, f)


def load(indexname: str) -> CondensedSeqSet:
    import json
    d = np.load(indexname + ".cse.npz")
    meta = json.load(open(indexname + ".cse.json"))
    store = CondensedSeqSet(descs=meta["descs"])
    store.uniques = [d[f"u{i}"] for i in range(meta["nuniques"])]
    for j, e in enumerate(meta["entries"]):
        if e[0] == "u":
            store.entries.append(("u", e[1]))
        else:
            tgt = d[f"t{j}"] if f"t{j}" in d else np.zeros(0, np.uint8)
            store.entries.append(("l", Link(
                e[1], e[2], [(op, c) for op, c in e[3]], tgt)))
    return store


def info(store: CondensedSeqSet) -> dict:
    """Statistics (ref: gt_condenseq_info.c)."""
    total = sum(store.extract(i).size for i in range(store.num_sequences))
    usize = sum(len(u) for u in store.uniques)
    nlinks = sum(1 for e in store.entries if e[0] == "l")
    return {
        "number of sequences": store.num_sequences,
        "total length": total,
        "unique sequences": len(store.uniques),
        "unique length": usize,
        "links": nlinks,
        "compressed size": store.compressed_size(),
        "compression ratio": round(store.compressed_size() / max(total, 1),
                                   4),
    }


def search(store: CondensedSeqSet, query: np.ndarray,
           kmersize: int = 16) -> list[tuple[int, int]]:
    """Exact-occurrence search against the compressed form (the
    seed-level capability of gt_condenseq_search.c: hits are found on
    the unique part only and expanded through the links): returns
    (seqnum, startpos) of every occurrence of `query` in the
    decompressed set, found by scanning uniques + remapping via links.
    """
    m = query.size
    out = []
    # occurrences inside unique blocks
    uhits: dict[int, list[int]] = {}
    for uid, u in enumerate(store.uniques):
        hits = []
        if u.size >= m:
            view = np.lib.stride_tricks.sliding_window_view(u, m)
            hits = np.flatnonzero((view == query).all(axis=1)).tolist()
        uhits[uid] = hits
    for i, (kind, val) in enumerate(store.entries):
        if kind == "u":
            out.extend((i, p) for p in uhits[val])
        else:
            # a linked sequence may differ from its unique reference:
            # verify on the (lazily) extracted sequence
            seq = store.extract(i)
            if seq.size >= m:
                view = np.lib.stride_tricks.sliding_window_view(seq, m)
                for p in np.flatnonzero((view == query).all(axis=1)):
                    out.append((i, int(p)))
    return out
