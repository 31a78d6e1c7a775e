"""FASTA reading for the plain references: each record's symbols as
uint8 codes, a/c/g/t (either case) as 0-3 and every other character as
4, a special that matches nothing. Imports numpy alone."""

from __future__ import annotations

import numpy as np

SPECIAL = 4

_LUT = np.full(256, SPECIAL, np.uint8)
for _i, _c in enumerate(b"acgt"):
    _LUT[_c] = _i
    _LUT[_c - 32] = _i


def read_records(path) -> list[np.ndarray]:
    """The records of a FASTA file, in file order, as code arrays."""
    raw = np.frombuffer(open(path, "rb").read(), np.uint8)
    heads = np.flatnonzero(raw == ord(">"))
    out = []
    for a, b in zip(heads, np.append(heads[1:], raw.size)):
        body = raw[a:b]
        nl = np.flatnonzero(body == 10)
        body = body[nl[0] + 1:] if nl.size else body[:0]
        body = body[(body != 10) & (body != 13)]
        out.append(_LUT[body])
    return out


def suffix_keys(records: list[np.ndarray]) -> np.ndarray:
    """int64 keys of the records joined by separators: a regular symbol
    is its code, the special at position p (a wildcard or a separator)
    is 4 + p, and the empty suffix at the end is 4 + n. Every special
    is a key of its own, so no two suffixes share one past it."""
    n = sum(r.size for r in records) + max(len(records) - 1, 0)
    keys = np.empty(n + 1, np.int64)
    p = 0
    for i, r in enumerate(records):
        if i:
            keys[p] = SPECIAL          # the separator, made unique below
            p += 1
        keys[p:p + r.size] = r
        p += r.size
    keys[n] = SPECIAL
    sp = np.flatnonzero(keys >= SPECIAL)
    keys[sp] = SPECIAL + sp
    return keys
