"""32/64-bit word helpers for the kernels' plain PyTorch versions.

Counterparts of the uint32-pair helpers in
``genometools_tpu/ops/greedy_batch.py`` (``_shl64``, ``_ones64``,
``_popcount64``, ``_ctz32``, ``_polish_walk``). PyTorch has no usable
unsigned 32-bit arithmetic on the CPU and no popcount operator, so a
32-bit word travels in an int64 tensor holding a value in [0, 2^32),
and popcount/ctz are SWAR bit tricks. A 64-bit history is a (lo, hi)
pair of such words.
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
NEGINF = -(2 ** 30)    # an empty slot's row


def _pos(c: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(c).to(torch.int64)


def shl64(hlo, hhi, c):
    """(hhi:hlo) << c for c >= 0; bits beyond 64 drop."""
    c = _pos(c).clamp(0, 64)
    a = c.clamp(0, 31)
    ra = (32 - c).clamp(1, 31)
    b = (c - 32).clamp(0, 31)
    lo_lt = (hlo << a) & M32
    carry = torch.where(c > 0, hlo >> ra, torch.zeros_like(hlo))
    hi_lt = ((hhi << a) & M32) | carry
    hi_ge = (hlo << b) & M32
    zero = torch.zeros_like(lo_lt)
    lo = torch.where(c >= 32, zero, lo_lt)
    hi = torch.where(c >= 64, zero, torch.where(c >= 32, hi_ge, hi_lt))
    return lo, hi


def ones64(c):
    """The low c bits set, as a (lo, hi) pair; c saturates at 64."""
    c = _pos(c).clamp(0, 64)
    lo = torch.where(c >= 32, torch.full_like(c, M32), (1 << c.clamp(0, 31)) - 1)
    hi = torch.where(c >= 64, torch.full_like(c, M32),
                     torch.where(c >= 32, (1 << (c - 32).clamp(0, 31)) - 1,
                                 torch.zeros_like(c)))
    return lo, hi


def popcount32(x):
    """Set bits of a 32-bit word held in int64."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24) & 0xFF


def popcount64(hlo, hhi):
    return popcount32(hlo) + popcount32(hhi)


def ctz32(x):
    """Trailing zeros of a 32-bit word; 32 for 0."""
    iso = x & (-x)
    return popcount32((iso - 1) & M32)


def polish_walk(prefix, match_score: int, difference_score: int,
                cut_depth: int):
    """(diff_from_max, score_sum) of a cut_depth-bit prefix, walked
    MSB-first as the reference's fill_polishing_info (ft-polish.c)."""
    score = torch.zeros_like(prefix)
    maxscore = torch.zeros_like(prefix)
    for b in range(cut_depth - 1, -1, -1):
        maxscore = torch.maximum(maxscore, score)
        bit = (prefix >> b) & 1
        score = score + torch.where(bit == 1, match_score, -difference_score)
    return score - maxscore, score


def to_i32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 words in [0, 2^32) -> int32 tensor with the same bits."""
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32)


def from_i32_bits(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> int64 words in [0, 2^32)."""
    return x.to(torch.int64) & M32
