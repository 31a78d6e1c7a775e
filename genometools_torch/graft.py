"""The flagship step as one callable: ``entry(device)`` -> ``(fn, (keys,))``.

The counterpart of the root ``__graft_entry__.py::entry()``: the suffix
array of a fixed block of 2^16 encoded-sequence keys (numpy seed 0, codes
0-3 and the sentinel key ``4 + n1 - 1``), built by prefix doubling
(``index/suffix.py::build_sa_impl``). ``keys`` lies on ``device``
(default cuda; a CUDA request without a card raises).
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .index.suffix import build_sa_impl

N1 = 1 << 16


def entry(device="cuda"):
    dev = resolve_device(device)

    def fn(keys: torch.Tensor) -> torch.Tensor:
        sa, _ = build_sa_impl(keys, False)
        return sa

    rng = np.random.default_rng(0)
    codes = rng.integers(0, 4, N1 - 1).astype(np.int32)
    keys = np.concatenate([codes, [4 + N1 - 1]]).astype(np.int32)
    return fn, (torch.from_numpy(keys).to(dev),)
