"""Bottom-up lcp-interval tree traversal with visitor callbacks.

The port's copy of ``genometools_tpu/match/esa_bottomup.py``: the
reference's generic bottom-up ESA walk (ref: src/match/esa-bottomup.c
gt_esa_bottomup: leaf-edge / branching-edge / lcp-interval callback
order, firstsucc flags, the final top-of-stack flush) and its three dev
consumers:

  * the lcp-interval enumerator      (ref: src/match/esa-lcpintervals.c,
    `gt dev sfxmap -enumlcpitvs`, "N <lcp> <lb> <rb>" lines)
  * the lcp-interval tree enumerator (`-enumlcpitvtree[BU]`,
    "L <f> <fd> <flb> <leaf>" / "B <f> <fd> <flb> <sd> <slb>" lines)
  * the suffix-prefix-match interval statistics visitor
    (ref: src/match/esa_spmitvs_visitor.c, `-spmitv`)

Host code: the walk is sequential over the (suftab, lcptab) the card
built. tests/test_torch_esa_bottomup.py holds its lines against the
gt-written tests/golden_lcpitv files.
"""

from __future__ import annotations

import numpy as np


class ESAVisitor:
    """Callback bundle; mirror of GtESAVisitor (ref: esa-visitor.c)."""

    def leafedge(self, firstsucc: bool, fd: int, flb: int,
                 leafnumber: int) -> None:
        pass

    def branchedge(self, firstsucc: bool, fd: int, flb: int,
                   sd: int, slb: int, srb: int) -> None:
        pass

    def lcpinterval(self, lcp: int, lb: int, rb: int) -> None:
        pass


def esa_bottomup(sa: np.ndarray, lcp: np.ndarray, nonspecials: int,
                 visitor: ESAVisitor) -> None:
    """ref: esa-bottomup.c:119-271 — byte-faithful edge order."""
    stack = [[0, 0, None]]                    # [lcp, lb, rb]
    firstedgefromroot = True
    lastsuftabvalue = 0
    idx = 0
    for idx in range(nonspecials):
        lcpvalue = int(lcp[idx + 1]) if idx + 1 < lcp.size else 0
        lastsuftabvalue = int(sa[idx + 1]) if idx + 1 < sa.size else 0
        previoussuffix = int(sa[idx])
        top = stack[-1]
        if lcpvalue <= top[0]:
            if top[0] > 0 or not firstedgefromroot:
                firstedge = False
            else:
                firstedge = True
                firstedgefromroot = False
            visitor.leafedge(firstedge, top[0], top[1], previoussuffix)
        lastinterval = None
        while lcpvalue < stack[-1][0]:
            lastinterval = stack.pop()
            lastinterval[2] = idx
            visitor.lcpinterval(lastinterval[0], lastinterval[1], idx)
            top = stack[-1]
            if lcpvalue <= top[0]:
                if top[0] > 0 or not firstedgefromroot:
                    firstedge = False
                else:
                    firstedge = True
                    firstedgefromroot = False
                visitor.branchedge(firstedge, top[0], top[1],
                                   lastinterval[0], lastinterval[1],
                                   lastinterval[2])
                lastinterval = None
        if lcpvalue > stack[-1][0]:
            if lastinterval is not None:
                llcp, llb, lrb = lastinterval
                stack.append([lcpvalue, llb, None])
                visitor.branchedge(True, lcpvalue, llb, llcp, llb, lrb)
            else:
                stack.append([lcpvalue, idx, None])
                visitor.leafedge(True, lcpvalue, idx, previoussuffix)
    if stack[-1][0] > 0:
        visitor.leafedge(False, stack[-1][0], stack[-1][1],
                         lastsuftabvalue)
        visitor.lcpinterval(stack[-1][0], stack[-1][1], idx)


class LcpIntervalPrinter(ESAVisitor):
    """`-enumlcpitvs` (ref: esa-lcpintervals.c processlcpinterval)."""

    def __init__(self, out):
        self.out = out

    def lcpinterval(self, lcp, lb, rb):
        self.out.write(f"N {lcp} {lb} {rb}\n")


class LcpTreePrinter(ESAVisitor):
    """`-enumlcpitvtree[BU]` (ref: esa-lcpintervals.c
    showbranchingedgeDFS / processleafedge_elcp)."""

    def __init__(self, out):
        self.out = out

    def leafedge(self, firstsucc, fd, flb, leafnumber):
        self.out.write(
            f"L {1 if firstsucc else 0} {fd} {flb} {leafnumber}\n")

    def branchedge(self, firstsucc, fd, flb, sd, slb, srb):
        self.out.write(
            f"B {1 if firstsucc else 0} {fd} {flb} {sd} {slb}\n")


class SpmitvsVisitor(ESAVisitor):
    """`-spmitv` (ref: esa_spmitvs_visitor.c): distribution of lcp
    intervals containing whole leaves (suffixes starting right after a
    separator — the suffix-prefix-match candidates)."""

    def __init__(self, encseq):
        from ..core.chardef import SEPARATOR
        self.total = encseq.total_length
        self.maxlen = encseq.max_seq_length()
        self.is_sep = encseq.codes == SEPARATOR
        self.unnecessaryleaves = 0
        self.currentleafindex = 0
        self.lastwholeleaf = self.total        # undefined
        z = self.maxlen + 1
        self.wl = np.zeros(z, np.int64)
        self.wlw = np.zeros(z, np.int64)
        self.nwl = np.zeros(z, np.int64)
        self.nwlw = np.zeros(z, np.int64)

    def _iswholeleaf(self, leafnumber: int) -> bool:
        return self.is_sep[leafnumber - 1] if leafnumber > 0 else True

    def leafedge(self, firstsucc, fd, flb, leafnumber):
        if self._iswholeleaf(leafnumber):
            self.lastwholeleaf = self.currentleafindex
        elif leafnumber + fd < self.total and \
                not self.is_sep[leafnumber + fd]:
            self.unnecessaryleaves += 1
        self.currentleafindex += 1

    def branchedge(self, firstsucc, fd, flb, sd, slb, srb):
        for i in range(fd + 1, sd):
            if self.lastwholeleaf != self.total and \
                    self.lastwholeleaf >= slb:
                self.wl[i] += 1
                self.wlw[i] += srb - slb + 1
            else:
                self.nwl[i] += 1
                self.nwlw[i] += srb - slb + 1

    def lcpinterval(self, lcp, lb, rb):
        if self.lastwholeleaf != self.total and \
                self.lastwholeleaf >= lb:
            self.wl[lcp] += 1
            self.wlw[lcp] += rb - lb + 1
        else:
            self.nwl[lcp] += 1
            self.nwlw[lcp] += rb - lb + 1

    def print_results(self, nonspecials: int, out) -> None:
        out.write(f"unnecessaryleaves={self.unnecessaryleaves} "
                  f"({self.unnecessaryleaves / nonspecials:.2f})\n")
        for i in range(self.maxlen + 1):
            if self.wl[i] or self.nwl[i]:
                num_r = self.wl[i] / (self.wl[i] + self.nwl[i])
                out.write(f"wholeleaf[{i}]:num={self.wl[i]} "
                          f"({num_r:.2f}), width={self.wlw[i]} "
                          f"({self.wlw[i] / self.total:.2f})\n")
