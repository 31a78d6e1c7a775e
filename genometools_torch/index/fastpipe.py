"""End-to-end suffixerator: FASTA -> .esq/.ssp/.des/.sds/.md5 +
.suf/.lcp/.llv/.prj (ref: src/match/sfx-run.c:428 gt_runsuffixerator).

Counterpart of ``genometools_tpu/index/fastpipe.py::suffixerator_e2e``,
the reference package's library entry, written through the CLI's path
for ``suffixerator -suf -lcp -tis``: Encseq.save, build_esa, write_esa.
"""

from __future__ import annotations

from ..core.encseq import Encseq
from ..device import resolve_device
from .esa import build_esa, write_esa


def suffixerator_e2e(fasta_paths: list[str], indexname: str,
                     device="cuda") -> None:
    """FASTA -> .esq/.ssp/.des/.sds/.md5 + .suf/.lcp/.llv/.prj, the
    suffix sort on `device` (see module docstring)."""
    dev = resolve_device(device)
    enc = Encseq.from_files(list(fasta_paths))
    enc.save(indexname)
    write_esa(build_esa(enc, device=dev), indexname)
