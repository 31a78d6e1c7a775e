"""Sequence reordering of an encoded sequence set (gt seqorder).

The port's copy of ``genometools_tpu/utils/seqorder.py`` (JAX-free
host code; the port imports nothing of the reference package).

Capability equivalent of the reference seqorder tool
(ref: src/tools/gt_seqorder.c): output the sequences of an encseq in a
chosen order — suffix order of the sequence-start suffixes (-sort /
-revsort, computed with the port's suffix engine on ``device`` instead
of the reference's in-memory suffix sorter), header order (-sorthdr /
-sorthdrnum), descending length (-sortlength), inverted (-invert) or
shuffled (-shuffle).
"""

from __future__ import annotations

import torch

from ..core.encseq import Encseq


def seqorder_permutation(encseq: Encseq, mode: str,
                         device="cuda") -> list[int]:
    """The order of the sequences; -sort/-revsort sort on ``device``
    (a CUDA request without a card raises), the other modes are host
    code."""
    n = encseq.num_sequences
    nums = list(range(n))
    if mode == "invert":
        return nums[::-1]
    if mode == "shuffle":
        import random
        rng = random.Random(0x5EED)
        rng.shuffle(nums)
        return nums
    if mode == "sorthdr":
        return sorted(nums, key=lambda i: encseq.descs[i])
    if mode == "sorthdrnum":
        def num(i):
            try:
                return int(encseq.descs[i].split()[0])
            except (ValueError, IndexError):
                return 0
        return sorted(nums, key=num)
    if mode == "sortlength":
        return sorted(nums, key=lambda i: -int(encseq.seq_length(i)))
    if mode in ("sort", "revsort"):
        # suffix order of the sequence-start suffixes over the whole
        # encseq (ref: gt_sortallsuffixesfromstart); the position-keyed
        # separator contract makes this exact
        from ..index.suffix import build_suffix_array
        sa, _ = build_suffix_array(encseq.suffix_keys(), with_lcp=False,
                                   device=device)
        sa = sa.long()
        rank = torch.empty_like(sa)
        rank[sa] = torch.arange(sa.numel(), device=sa.device)
        starts = torch.tensor([int(encseq.seq_startpos(i))
                               for i in range(n)], device=sa.device)
        srank = rank[starts].tolist()      # the start suffixes' ranks only
        order = sorted(nums, key=lambda i: srank[i])
        return order[::-1] if mode == "revsort" else order
    raise ValueError(f"unknown seqorder mode {mode!r}")


def render_fasta(encseq: Encseq, order: list[int]) -> str:
    """One header + one sequence line per entry
    (ref: gt_seqorder.c:253 gt_seqorder_output)."""
    out = []
    for i in order:
        start = int(encseq.seq_startpos(i))
        length = int(encseq.seq_length(i))
        out.append(">" + (encseq.descs[i] if i < len(encseq.descs)
                          else ""))
        out.append(encseq.extract_decoded(start, start + length - 1))
    return "\n".join(out) + "\n"
