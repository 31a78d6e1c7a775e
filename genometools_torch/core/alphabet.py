"""Alphabet: character <-> code mapping.

The port's copy of ``genometools_tpu/core/alphabet.py``
(JAX-free host code; the port imports nothing of the reference
package).

Capability equivalent of the reference GtAlphabet (ref: src/core/alphabet.c):
DNA maps aA->0 cC->1 gG->2 tTuU->3 and ambiguity codes
(swSW, rySRY, mkMK, bdhvBDHV, nN, ...) to WILDCARD; protein maps the 20
amino acids to 0..19 with ambiguity codes X/B/Z/U/* etc. to WILDCARD.
Custom alphabets are definable from groups of equivalent characters.

All mapping is table-driven (a 256-entry uint8 LUT) so encoding whole
byte buffers is a single vectorized gather — this is the encode hot path.
"""

from __future__ import annotations

import numpy as np

from .chardef import UNDEFCHAR, WILDCARD

_DNA_GROUPS = ["aA", "cC", "gG", "tTuU"]
_DNA_WILDCARDS = "nsywrkvbdhmNSYWRKVBDHM"

_PROTEIN_GROUPS = [
    "L", "V", "I", "F", "K", "R", "E", "D", "A", "G",
    "S", "T", "N", "Q", "Y", "W", "P", "H", "M", "C",
]
_PROTEIN_WILDCARDS = "XUBZJO*-"


class Alphabet:
    """Immutable char<->code map with a 256-entry encode LUT.

    ``characters`` holds one printable representative per regular code
    (used for decoding); ``wildcard_show`` is the character used to print
    wildcards.
    """

    def __init__(self, groups: list[str], wildcards: str, wildcard_show: str):
        self.groups = list(groups)
        self.wildcards = wildcards
        self.num_chars = len(groups)
        self.characters = "".join(g[0] for g in groups)
        self.wildcard_show = wildcard_show

        lut = np.full(256, UNDEFCHAR, dtype=np.uint8)
        for code, group in enumerate(groups):
            for ch in group:
                lut[ord(ch)] = code
        for ch in wildcards:
            lut[ord(ch)] = WILDCARD
        self._encode_lut = lut

        dlut = np.full(256, ord("?"), dtype=np.uint8)
        for code, group in enumerate(groups):
            dlut[code] = ord(group[0])
        dlut[WILDCARD] = ord(wildcard_show)
        self._decode_lut = dlut

    # -- classification ----------------------------------------------------
    def is_dna(self) -> bool:
        return self.groups == _DNA_GROUPS

    def is_protein(self) -> bool:
        return self.groups == _PROTEIN_GROUPS

    # -- encoding ----------------------------------------------------------
    def encode(self, data: bytes | np.ndarray) -> np.ndarray:
        """Encode raw bytes to uint8 codes (vectorized LUT gather)."""
        buf = np.frombuffer(data, dtype=np.uint8) if isinstance(
            data, (bytes, bytearray)) else np.asarray(data, dtype=np.uint8)
        return self._encode_lut[buf]

    def valid(self, data: bytes | np.ndarray) -> np.ndarray:
        """Boolean mask of which input bytes are mapped (regular or wildcard)."""
        return self.encode(data) != UNDEFCHAR

    def decode(self, codes: np.ndarray, separator: str = "|") -> str:
        """Decode uint8 codes back to a printable string."""
        out = self._decode_lut[np.asarray(codes, dtype=np.uint8)]
        s = out.tobytes().decode("latin-1")
        if separator != "|":
            s = s.replace("|", separator)
        return s

    def complement_table(self) -> np.ndarray:
        """Code-level complement LUT (DNA): 0<->3, 1<->2; specials fixed."""
        tab = np.arange(256, dtype=np.uint8)
        if self.is_dna():
            tab[0], tab[1], tab[2], tab[3] = 3, 2, 1, 0
        return tab


def dna_alphabet() -> Alphabet:
    a = Alphabet(_DNA_GROUPS, _DNA_WILDCARDS, "n")
    # decode separators as '|' like the reference pretty-printer
    a._decode_lut[255] = ord("|")
    return a


def protein_alphabet() -> Alphabet:
    a = Alphabet(_PROTEIN_GROUPS, _PROTEIN_WILDCARDS, "X")
    a._decode_lut[255] = ord("|")
    return a


def guess_alphabet(sample: bytes) -> Alphabet:
    """Guess DNA vs protein from a sequence sample (ref: gt_alphabet_guess)."""
    dna = dna_alphabet()
    arr = np.frombuffer(sample, dtype=np.uint8)
    arr = arr[(arr != ord("\n")) & (arr != ord(" ")) & (arr != ord("-"))]
    if arr.size == 0:
        return dna
    codes = dna.encode(arr)
    frac_dna = float(np.mean(codes != UNDEFCHAR))
    return dna if frac_dna >= 0.9 else protein_alphabet()
