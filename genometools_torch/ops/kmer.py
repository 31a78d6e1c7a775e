"""k-mer codes: the device window scan and the host (numpy) helpers.

The port's counterpart of ``genometools_tpu/ops/kmer.py``. ``kmer_codes``
is its device scan (ref: GtKmercodeiterator, src/match/sfx-mappedstr.c:
427-483, as a data-parallel window scan) in torch on an explicit
device. The reference splits codes wider than 30 bits into int32 words
because the TPU has no fast int64; here each window is one int64 word
while it fits (4-letter alphabet: k <= 31) and is split into the
reference's words only on the way out.
"""

from __future__ import annotations

import math

import numpy as np

from ..core.chardef import SPECIAL_MIN


def _word_sizes(k: int, num_chars: int) -> list[int]:
    """Symbols per int32 word, most significant first, as the reference
    splits k (the first word may be short)."""
    per = 30 // math.ceil(math.log2(num_chars))
    nwords = (k + per - 1) // per
    sizes, rem = [], k
    for w in range(nwords):
        take = max(1, min(per, rem - per * (nwords - 1 - w)))
        sizes.append(take)
        rem -= take
    return sizes


def kmer_codes64(codes, k: int, num_chars: int = 4, device="cuda"):
    """(code int64[npos], valid bool[npos]) of every k-window of a code
    array on `device` (npos = n - k + 1): code is the window's base-
    num_chars value with specials read as 0, valid is False where the
    window holds a special. Needs num_chars**k < 2^63 (k <= 31 for DNA)."""
    import torch

    from ..device import resolve_device
    dev = resolve_device(device)
    if num_chars ** k >= 2 ** 63:
        raise ValueError(f"{k}-mers over {num_chars} letters do not fit "
                         "one int64 word")
    c = torch.as_tensor(np.asarray(codes) if not isinstance(
        codes, torch.Tensor) else codes).to(dev)
    npos = c.numel() - k + 1
    if npos < 1:
        raise ValueError("sequence shorter than k")
    special = c >= SPECIAL_MIN
    sym = torch.where(special, 0, c.to(torch.int64))
    code = torch.zeros(npos, dtype=torch.int64, device=dev)
    bad = torch.zeros(npos, dtype=torch.bool, device=dev)
    for j in range(k):
        code = code * num_chars + sym[j:j + npos]
        bad |= special[j:j + npos]
    return code, ~bad


def kmer_codes(codes, k: int, num_chars: int = 4, device="cuda"):
    """All k-mer codes of a uint8 code array, as the reference returns
    them: (words int32[nwords, npos], most significant word first;
    valid bool[npos], False where the window holds a special)."""
    import torch
    sizes = _word_sizes(k, num_chars)
    if num_chars ** k < 2 ** 63:
        code, valid = kmer_codes64(codes, k, num_chars, device)
        words = []
        for size in reversed(sizes):
            words.append(code % num_chars ** size)
            code = code // num_chars ** size
        return torch.stack(words[::-1]).to(torch.int32), valid
    # wider than one word: scan each word's symbols on their own
    words, valid, off = [], None, 0
    for size in sizes:
        part = torch.as_tensor(np.asarray(codes) if not isinstance(
            codes, torch.Tensor) else codes)[off:]
        w, v = kmer_codes64(part, size, num_chars, device)
        npos = part.numel() - size + 1 - (k - off - size)
        words.append(w[:npos].to(torch.int32))
        valid = v[:npos] if valid is None else valid & v[:npos]
        off += size
    return torch.stack(words), valid


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
    sizes = _word_sizes(k, num_chars)
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
