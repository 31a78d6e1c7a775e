"""PyTorch/CUDA port of genometools_tpu.

The JAX package ``genometools_tpu`` stays the reference. This package
imports nothing of it: it owns the counterparts of the reference
modules that call JAX, and keeps its own copies of the JAX-free host
modules it needs (``core/``: ``Encseq`` and the native C++ loader;
``ops/greedy.py`` and ``ops/xdrop.py``: the scalar oracles;
``utils/options.py``, ``match/seedext_display.py``,
``match/karlin_altschul.py`` and the CLI parsers).

Every function that touches tensors takes an explicit ``device``; a
CUDA request without a card raises (``device.resolve_device``). On a
CUDA tensor each kernel wrapper launches its hand-written kernel
(``csrc/``); on a CPU tensor it runs the kernel's plain PyTorch
version.
"""

__version__ = "0.1.0"

from .device import resolve_device

__all__ = ["resolve_device"]
