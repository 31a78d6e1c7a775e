"""Character-level constants for encoded sequences.

The port's copy of ``genometools_tpu/core/chardef.py``
(JAX-free host code; the port imports nothing of the reference
package).

Semantics follow the reference GenomeTools chardef conventions
(ref: src/core/chardef.h:33-57): encoded characters are uint8 codes;
the top of the code space is reserved for special characters.

  SEPARATOR (255) -- separates concatenated sequences
  WILDCARD  (254) -- ambiguity characters (N, S, Y, ...)
  UNDEFCHAR (253) -- undefined character

A character is "special" iff code >= WILDCARD.
"""

from __future__ import annotations

import numpy as np

SEPARATOR = 255
WILDCARD = 254
UNDEFCHAR = 253

# Everything >= WILDCARD is special (separator or wildcard).
SPECIAL_MIN = WILDCARD


def is_special(codes: np.ndarray) -> np.ndarray:
    """Vectorized ISSPECIAL over an array of uint8 codes."""
    return codes >= SPECIAL_MIN


def is_separator(codes: np.ndarray) -> np.ndarray:
    return codes == SEPARATOR


def is_wildcard(codes: np.ndarray) -> np.ndarray:
    return codes == WILDCARD
