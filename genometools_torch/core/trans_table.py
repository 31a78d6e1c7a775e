"""NCBI translation tables (ref: src/core/trans_table.c schemetable).

The port's copy of ``genometools_tpu/core/trans_table.py`` (JAX-free
host code; the port imports nothing of the reference package).

Scheme data is the public NCBI genetic-code table
(http://www.ncbi.nlm.nih.gov/Taxonomy/Utils/wprintgc.cgi): 64 amino
acids in TCAG-major codon order plus the start-codon mask.  The
reference exposes tables by their NCBI identity number with gaps
(7, 8, 17-20 are retired NCBI numbers, ref: trans_table.c
transnum2index).
"""

from __future__ import annotations

CODON_LENGTH = 3
STANDARD = 1

_BASES = "TCAG"
_BASE_INDEX = {}
for _i, _b in enumerate(_BASES):
    _BASE_INDEX[_b] = _i
    _BASE_INDEX[_b.lower()] = _i
_BASE_INDEX["U"] = _BASE_INDEX["u"] = _BASE_INDEX["T"]

# (identity, name, aminos[64], startcodons[64])
_SCHEMES = [
    (1, "Standard",
     "FFLLSSSSYY**CC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
     "---M---------------M---------------M----------------------------"),
    (2, "Vertebrate Mitochondrial",
     "FFLLSSSSYY**CCWWLLLLPPPPHHQQRRRRIIMMTTTTNNKKSS**VVVVAAAADDEEGGGG",
     "--------------------------------MMMM---------------M------------"),
    (3, "Yeast Mitochondrial",
     "FFLLSSSSYY**CCWWTTTTPPPPHHQQRRRRIIMMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
     "----------------------------------MM----------------------------"),
    (4, "Mold Mitochondrial; Protozoan Mitochondrial; Coelenterate "
        "Mitochondrial; Mycoplasma; Spiroplasma",
     "FFLLSSSSYY**CCWWLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
     "--MM---------------M------------MMMM---------------M------------"),
    (5, "Invertebrate Mitochondrial",
     "FFLLSSSSYY**CCWWLLLLPPPPHHQQRRRRIIMMTTTTNNKKSSSSVVVVAAAADDEEGGGG",
     "---M----------------------------MMMM---------------M------------"),
    (6, "Ciliate Nuclear; Dasycladacean Nuclear; Hexamita Nuclear",
     "FFLLSSSSYYQQCC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
     "-----------------------------------M----------------------------"),
    (9, "Echinoderm Mitochondrial; Flatworm Mitochondrial",
     "FFLLSSSSYY**CCWWLLLLPPPPHHQQRRRRIIIMTTTTNNNKSSSSVVVVAAAADDEEGGGG",
     "-----------------------------------M---------------M------------"),
    (10, "Euplotid Nuclear",
     "FFLLSSSSYY**CCCWLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
     "-----------------------------------M----------------------------"),
    (11, "Bacterial, Archaeal and Plant Plastid",
     "FFLLSSSSYY**CC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
     "---M---------------M------------MMMM---------------M------------"),
    (12, "Alternative Yeast Nuclear",
     "FFLLSSSSYY**CC*WLLLSPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
     "-------------------M---------------M----------------------------"),
    (13, "Ascidian Mitochondrial",
     "FFLLSSSSYY**CCWWLLLLPPPPHHQQRRRRIIMMTTTTNNKKSSGGVVVVAAAADDEEGGGG",
     "---M------------------------------MM---------------M------------"),
    (14, "Alternative Flatworm Mitochondrial",
     "FFLLSSSSYYY*CCWWLLLLPPPPHHQQRRRRIIIMTTTTNNNKSSSSVVVVAAAADDEEGGGG",
     "-----------------------------------M----------------------------"),
    (15, "Blepharisma Macronuclear",
     "FFLLSSSSYY*QCC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
     "-----------------------------------M----------------------------"),
    (16, "Chlorophycean Mitochondrial",
     "FFLLSSSSYY*LCC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
     "-----------------------------------M----------------------------"),
    (21, "Trematode Mitochondrial",
     "FFLLSSSSYY**CCWWLLLLPPPPHHQQRRRRIIMMTTTTNNNKSSSSVVVVAAAADDEEGGGG",
     "-----------------------------------M---------------M------------"),
    (22, "Scenedesmus obliquus Mitochondrial",
     "FFLLSS*SYY*LCC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
     "-----------------------------------M----------------------------"),
    (23, "Thraustochytrium Mitochondrial",
     "FF*LSSSSYY**CC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
     "--------------------------------M--M---------------M------------"),
    (24, "Pterobranchia Mitochondrial",
     "FFLLSSSSYY**CCWWLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSSKVVVVAAAADDEEGGGG",
     "---M---------------M---------------M---------------M------------"),
    (25, "Candidate Division SR1 and Gracilibacteria",
     "FFLLSSSSYY**CCGWLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
     "---M-------------------------------M---------------M------------"),
]

_BY_NUMBER = {num: (name, aminos, starts)
              for num, name, aminos, starts in _SCHEMES}


class TransTable:
    """One NCBI genetic code (ref: trans_table.c GtTransTable)."""

    def __init__(self, number: int = STANDARD):
        if number not in _BY_NUMBER:
            raise ValueError(
                f"'{number}' is not a valid translation table number!")
        self.number = number
        self.name, self._aminos, self._starts = _BY_NUMBER[number]

    @staticmethod
    def _codon_code(c1: str, c2: str, c3: str) -> int:
        try:
            return (_BASE_INDEX[c1] * 16 + _BASE_INDEX[c2] * 4
                    + _BASE_INDEX[c3])
        except KeyError as exc:
            raise ValueError(f"illegal codon character {exc}") from None

    def translate(self, c1: str, c2: str, c3: str) -> str:
        """ref: gt_trans_table_translate_codon."""
        return self._aminos[self._codon_code(c1, c2, c3)]

    def translate_str(self, seq: str) -> str:
        return "".join(self.translate(*seq[i:i + 3])
                       for i in range(0, len(seq) - 2, 3))

    def is_stop_codon(self, c1: str, c2: str, c3: str) -> bool:
        return self._aminos[self._codon_code(c1, c2, c3)] == "*"

    def is_start_codon(self, c1: str, c2: str, c3: str) -> bool:
        return self._starts[self._codon_code(c1, c2, c3)] == "M"


def scheme_descriptions() -> list[str]:
    """ref: gt_trans_table_get_scheme_descriptions (number: name)."""
    return [f"{num}: {name}" for num, name, _, _ in _SCHEMES]
