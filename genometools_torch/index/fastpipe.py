"""End-to-end suffixerator on the card: FASTA -> .esq/.ssp/.des/.sds/.md5
+ .suf/.lcp/.llv/.prj (ref: src/match/sfx-run.c:428 gt_runsuffixerator).

Counterpart of ``genometools_tpu/index/fastpipe.py::suffixerator_e2e``,
a library entry (the CLI keeps build_esa + write_esa):

  * the encseq writers (core/esq.py::write_all) run on a host thread
    while the card builds the suffix keys from the uploaded uint8 codes
    and runs the packed pipeline (index/suffix.py);
  * the card then reduces the LCP table to what the files hold: the
    uint8 plane (min(lcp, 255)), the overflow pairs (lcp >= 255),
    maxbranchdepth, the averagelcp numerator as one int64 sum and
    `longest`; the suffix table comes back as int32.

The reference's transfer tricks for a remote TPU link (a 2-bit upload,
a split-plane suffix table, a 6-bit LCP plane with escapes, a chunked
threaded fetch) and its host SA-IS route below 4M symbols are not
carried over: the card sorts every input it is given. Files are
byte-identical to the slow path (build_esa + write_esa + Encseq.save).
"""

from __future__ import annotations

import threading
from types import SimpleNamespace

import numpy as np
import torch

from ..core.chardef import SPECIAL_MIN
from ..core.encseq import FWD, Encseq
from ..core.esq import write_all
from ..device import resolve_device
from .esa import LCP_OVERFLOW, _write_prj, recommended_prefixlength
from .suffix import build_suffix_array


def _device_keys(codes: torch.Tensor, sigma: int):
    """(int32 suffix keys, special mask) on the codes' device: regular
    symbol -> code, special at p and the sentinel -> sigma + p (the
    contract of Encseq.suffix_keys)."""
    n = codes.shape[0]
    if n + sigma >= 2 ** 31:
        raise NotImplementedError("keys beyond int32 are not ported yet")
    special = codes >= SPECIAL_MIN
    pos = torch.arange(n + 1, dtype=torch.int32, device=codes.device)
    keys = sigma + pos
    keys[:n] = torch.where(special, keys[:n], codes.to(torch.int32))
    return keys, special


def _lcp_tables(sa, lcp, special, pl: int):
    """What .lcp/.llv/.prj need, reduced on the card: the uint8 plane,
    the overflow pairs, maxbranchdepth, the averagelcp numerator (lcp
    summed over the suffixes whose prefixlength window lies inside the
    sequence and holds no special; ref: sfx-lcpvalues.c:414) and the
    suftab slot of the whole sequence (longest)."""
    n = special.shape[0]
    plane = lcp.clamp(max=LCP_OVERFLOW).to(torch.uint8)
    ovf = torch.nonzero(lcp >= LCP_OVERFLOW).squeeze(1)
    spc = torch.zeros(n + 1, dtype=torch.int32, device=lcp.device)
    torch.cumsum(special, 0, dtype=torch.int32, out=spc[1:])
    s = sa.to(torch.int64)
    valid = s + pl <= n
    end = (s + pl).clamp_(max=n)
    free = valid & (spc[end] == spc[s])
    lcpsum = torch.where(free, lcp, 0).sum(dtype=torch.int64)
    return (plane, ovf, lcp[ovf], lcp.max(), lcpsum,
            torch.nonzero(sa == 0)[0, 0])


def suffixerator_e2e(fasta_paths: list[str], indexname: str,
                     device="cuda") -> None:
    """FASTA -> .esq/.ssp/.des/.sds/.md5 + .suf/.lcp/.llv/.prj, the suffix
    sort and the LCP reductions on `device` (see module docstring)."""
    dev = resolve_device(device)
    enc = Encseq.from_files(list(fasta_paths))
    n = enc.total_length
    sigma = enc.alphabet.num_chars
    pl = recommended_prefixlength(sigma, n)
    errs: list[BaseException] = []

    def write_encseq():
        try:
            write_all(enc, indexname)
        except BaseException as exc:     # noqa: BLE001 re-raised below
            errs.append(exc)

    writer = threading.Thread(target=write_encseq)
    writer.start()
    try:
        keys, special = _device_keys(torch.from_numpy(enc.codes).to(dev),
                                     sigma)
        sa, lcp = build_suffix_array(keys, with_lcp=True, device=dev)
        del keys
        plane, ovf, ovf_val, maxbd, lcpsum, longest = \
            _lcp_tables(sa, lcp, special, pl)
        del lcp, special
        sa.cpu().numpy().astype(np.uint64).tofile(indexname + ".suf")
        plane.cpu().numpy().tofile(indexname + ".lcp")
        llv = np.empty((ovf.numel(), 2), np.uint64)
        llv[:, 0] = ovf.cpu().numpy()
        llv[:, 1] = ovf_val.cpu().numpy()
        llv.tofile(indexname + ".llv")
        n1 = n + 1
        carrier = SimpleNamespace(
            encseq=enc, readmode=FWD, prefixlength=pl,
            longest=int(longest), suftab=SimpleNamespace(size=n1))
        _write_prj(carrier, indexname, int(ovf.numel()),
                   int(lcpsum) / n1, int(maxbd), 64)
    finally:
        writer.join()
    if errs:
        raise errs[0]
