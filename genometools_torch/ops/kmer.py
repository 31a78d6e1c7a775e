"""Host k-mer code helpers (numpy).

The numpy half of ``genometools_tpu/ops/kmer.py`` (the reference module
also holds a JAX scan, so it cannot be imported without JAX). With one
int64 word per code, k <= 31 needs no multi-word split here.
"""

from __future__ import annotations

import numpy as np

from ..core.chardef import SPECIAL_MIN


def kmer_codes_np(codes: np.ndarray, k: int, num_chars: int = 4):
    """Host reference implementation (numpy) for cross-checks."""
    n = codes.size
    npos = n - k + 1
    sym = np.where(codes >= SPECIAL_MIN, 0, codes).astype(np.int64)
    special = codes >= SPECIAL_MIN
    code = np.zeros(npos, np.int64)
    bad = np.zeros(npos, bool)
    for j in range(k):
        code = code * num_chars + sym[j:j + npos]
        bad |= special[j:j + npos]
    return code, ~bad


def words_to_int(words: np.ndarray, k: int, num_chars: int = 4) -> np.ndarray:
    """Combine the reference's multi-word int32 codes (most significant
    word first) into int64 codes."""
    import math
    bits = math.ceil(math.log2(num_chars))
    per = 30 // bits
    nwords = words.shape[0]
    sizes = []
    rem = k
    for w in range(nwords):
        take = rem - per * (nwords - 1 - w)
        take = max(1, min(per, take))
        sizes.append(take)
        rem -= take
    out = np.zeros(words.shape[1], np.int64)
    for w, size in enumerate(sizes):
        out = out * (num_chars ** size) + words[w].astype(np.int64)
    return out


def pack_mers_2bit(mer_codes: np.ndarray, k: int) -> np.ndarray:
    """Pack k-mer integer codes into ceil(k/4)-byte big-endian 2-bit strings
    (the reference Tallymer .mer layout, ref: src/match/tyr-basic.h:24-28:
    MERBYTES(k) = (k + 3) / 4, symbols packed MSB-first per byte)."""
    merbytes = (k + 3) // 4
    npos = mer_codes.size
    out = np.zeros((npos, merbytes), np.uint8)
    # pad to multiple of 4 symbols on the right (low bits of last byte zero)
    shift_total = (merbytes * 4 - k) * 2
    vals = mer_codes.astype(object) if k > 31 else mer_codes.astype(np.int64)
    vals = vals << shift_total
    for b in range(merbytes - 1, -1, -1):
        out[:, b] = np.asarray(vals & 0xFF, np.uint8)
        vals = vals >> 8
    return out


def spaced_kmer_codes_np(codes: np.ndarray, mask: int, num_chars: int = 4):
    """Spaced-seed codes: `mask` is a bitmask over the seed span
    (MSB = first window position); only 1-bit positions contribute to the
    code (ref: src/match/dbs_spaced_seeds.c, diagbandseed spaced-seed
    extraction). Returns (codes int64[npos], valid bool[npos]) where
    validity requires the FULL span free of specials (like the
    reference's window scan)."""
    span = mask.bit_length()
    weight_positions = [span - 1 - b for b in range(span - 1, -1, -1)
                        if (mask >> b) & 1]
    n = codes.size
    npos = n - span + 1
    if npos <= 0:
        return np.zeros(0, np.int64), np.zeros(0, bool)
    sym = np.where(codes >= SPECIAL_MIN, 0, codes).astype(np.int64)
    special = codes >= SPECIAL_MIN
    out = np.zeros(npos, np.int64)
    bad = np.zeros(npos, bool)
    for j in range(span):
        bad |= special[j:j + npos]
    for j in weight_positions:
        out = out * num_chars + sym[j:j + npos]
    return out, ~bad
