"""Gene prediction evaluation (gt eval).

The port's copy of ``genometools_tpu/anno/eval.py`` (JAX-free
host code; the port imports nothing of the reference package).

Capability equivalent of the reference stream evaluator
(ref: src/extended/stream_evaluator.c, evaluator.c,
transcript_evaluators.c, tools/gt_eval.c): compare a "prediction"
annotation against a "reality" annotation and report sensitivity /
specificity on gene, mRNA, exon (all/single/initial/internal/terminal,
plain + collapsed) and nucleotide levels, plus missing/wrong feature
counts.  An LTR mode compares LTR_retrotransposon features with a
range delta.

Validated against testdata/gt_eval_test_{1..10}.{out,nuc},
gt_eval_prob_1.out{,_swapped} and gt_eval_ltr_test_{1..9}.out.
"""

from __future__ import annotations

import numpy as np

from .genome_node import FeatureNode, GenomeNode, Range, RegionNode

_CATS = ("all", "single", "initial", "internal", "terminal")


class Evaluator:
    """T/A/P counter (ref: evaluator.c)."""

    def __init__(self):
        self.T = 0
        self.A = 0
        self.P = 0

    def sensitivity(self) -> float:
        return self.T / self.A if self.A else 1.0

    def specificity(self) -> float:
        return self.T / self.P if self.P else 1.0

    def show_sensitivity(self) -> str:
        return f"{self.sensitivity() * 100.0:6.2f}% ({self.T}/{self.A})"

    def show_specificity(self) -> str:
        return f"{self.specificity() * 100.0:6.2f}% ({self.T}/{self.P})"


class TranscriptEvaluators:
    """One Evaluator per exon category (ref: transcript_evaluators.c)."""

    def __init__(self):
        self.evals = {c: Evaluator() for c in _CATS}

    def __getitem__(self, cat: str) -> Evaluator:
        return self.evals[cat]


def _determine_transcript_types(top: FeatureNode) -> None:
    """Tag every exon/CDS with single/initial/internal/terminal based on
    its position among its parent's direct children in range order
    (the reference keeps children in a range-sorted dlist —
    feature_node.c:1104 — so document order is irrelevant; ref:
    feature_node.c:560 set_transcript_types; reverse-strand parents
    swap initial/terminal)."""
    for node in _traverse(top):
        kids = sorted(node.children,
                      key=lambda c: (c.range.start, c.range.end))
        exons = [c for c in kids if c.type == "exon"]
        cdss = [c for c in kids if c.type == "CDS"]
        for feats in (exons, cdss):
            if not feats:
                continue
            if len(feats) == 1:
                feats[0]._ttype = "single"
            else:
                rev = node.strand == "-"
                feats[0]._ttype = "terminal" if rev else "initial"
                for f in feats[1:-1]:
                    f._ttype = "internal"
                feats[-1]._ttype = "initial" if rev else "terminal"


def _traverse(top: FeatureNode):
    out = []

    def rec(n):
        out.append(n)
        for c in n.children:
            rec(c)

    rec(top)
    return out


def _ttype(fn: FeatureNode) -> str:
    # undetermined (no parent) is treated as single (ref: add_real_exon)
    return getattr(fn, "_ttype", "single")


def _bsearch_all(key, arr, cmp):
    """All indices comparing equal to key, in the reference's discovery
    order: bsearch hit first, then left scan, then right scan
    (ref: src/core/bsearch.c bsearch_generic)."""
    members = []
    base = 0
    limit = len(arr)
    while limit != 0:
        idx = base + (limit >> 1)
        rval = cmp(key, arr[idx])
        if rval == 0:
            members.append(idx)
            i = idx - 1
            while i >= 0 and cmp(key, arr[i]) == 0:
                members.append(i)
                i -= 1
            i = idx + 1
            while i < len(arr) and cmp(key, arr[i]) == 0:
                members.append(i)
                i += 1
            return members
        if rval > 0:
            base = idx + 1
            limit -= 1
        limit >>= 1
    return members


def _range_cmp(a: Range, b: Range) -> int:
    if (a.start, a.end) < (b.start, b.end):
        return -1
    if (a.start, a.end) > (b.start, b.end):
        return 1
    return 0


def _range_cmp_delta(a: Range, b: Range, delta: int) -> int:
    """ref: core/range.c:39 gt_range_compare_with_delta."""
    if abs(a.start - b.start) <= delta and abs(a.end - b.end) <= delta:
        return 0
    return _range_cmp(a, b)


def _exon_ranges(fn: FeatureNode, ftype: str) -> list[tuple[int, int]]:
    return sorted((m.range.start, m.range.end) for m in _traverse(fn)
                  if m.type == ftype)


def _mrnas_are_equal(m1: FeatureNode, m2: FeatureNode, ftype: str) -> bool:
    """ref: stream_evaluator.c:585 mRNAs_are_equal."""
    return _exon_ranges(m1, ftype) == _exon_ranges(m2, ftype)


def _genes_are_equal(g1: FeatureNode, g2: FeatureNode, ftype: str) -> bool:
    """ref: stream_evaluator.c:647 genes_are_equal: direct-children exon
    ranges must match; mRNA lists are compared pairwise only when both
    genes have the same number of mRNAs."""

    def direct(g):
        ex = sorted((c.range.start, c.range.end) for c in g.children
                    if c.type == ftype)
        mr = sorted((c for c in g.children if c.type == "mRNA"),
                    key=lambda m: (m.range.start, m.range.end))
        return ex, mr

    ex1, mr1 = direct(g1)
    ex2, mr2 = direct(g2)
    equal = ex1 == ex2
    if equal and len(mr1) == len(mr2):
        for a, b in zip(mr1, mr2):
            if not _mrnas_are_equal(a, b, ftype):
                return False
    return equal


class _ExonSide:
    """Per-strand real exon bookkeeping for one level (mRNA or CDS):
    category range lists -> sorted unique ranges + multiplicities +
    collapsed bittabs (ref: transcript_exons.c)."""

    def __init__(self):
        self.raw = {c: [] for c in _CATS}
        self.uniq: dict[str, list] = {}
        self.counts: dict[str, list] = {}
        self.hit: dict[str, np.ndarray] = {}

    def add(self, rng: Range, cat: str):
        t = (rng.start, rng.end)
        self.raw["all"].append(t)
        self.raw[cat].append(t)

    def finalize(self):
        for c in _CATS:
            rs = sorted(self.raw[c])
            uniq, counts = [], []
            for t in rs:
                if uniq and uniq[-1] == t:
                    counts[-1] += 1
                else:
                    uniq.append(t)
                    counts.append(1)
            self.uniq[c] = uniq
            self.counts[c] = counts
            self.hit[c] = np.zeros(len(uniq), dtype=bool)


class _Slot:
    """Per-seqid reality data (ref: stream_evaluator.c:145 Slot)."""

    def __init__(self, rng: Range, nuceval: bool):
        self.range = rng
        self.nuceval = nuceval
        self.genes = {"+": [], "-": []}
        self.mrnas = {"+": [], "-": []}
        self.ltrs: list[FeatureNode] = []
        self.exons = {("mRNA", "+"): _ExonSide(), ("mRNA", "-"): _ExonSide(),
                      ("CDS", "+"): _ExonSide(), ("CDS", "-"): _ExonSide()}
        if nuceval:
            n = rng.length
            self.real_nuc = {k: np.zeros(n, dtype=bool) for k in self.exons}
            self.pred_nuc = {k: np.zeros(n, dtype=bool) for k in self.exons}
        self.FP_out_of_range = {("mRNA", "+"): 0, ("mRNA", "-"): 0,
                                ("CDS", "+"): 0, ("CDS", "-"): 0}
        # used (collapsed) predicted exon ranges per level/strand/category
        self.used = {k: {c: set() for c in _CATS} for k in self.exons}
        self.finalized = False

    def set_nuc(self, tab: np.ndarray, rng: Range) -> int:
        """Set bits of rng clipped to the slot range; return the number
        of out-of-range positions (ref: add_nucleotide_exon)."""
        lo = max(rng.start, self.range.start)
        hi = min(rng.end, self.range.end)
        inside = max(0, hi - lo + 1)
        if inside:
            tab[lo - self.range.start:hi - self.range.start + 1] = True
        return rng.length - inside

    def finalize(self):
        for key in ("genes", "mrnas"):
            d = getattr(self, key)
            for s in d:
                d[s].sort(key=lambda f: (f.range.start, f.range.end))
        self.ltrs.sort(key=lambda f: (f.range.start, f.range.end))
        for side in self.exons.values():
            side.finalize()
        self.true_genes = {lvl: {s: np.zeros(len(self.genes[s]), dtype=bool)
                                 for s in "+-"} for lvl in ("mRNA", "CDS")}
        self.true_mrnas = {lvl: {s: np.zeros(len(self.mrnas[s]), dtype=bool)
                                 for s in "+-"} for lvl in ("mRNA", "CDS")}
        self.true_ltrs = np.zeros(len(self.ltrs), dtype=bool)
        self.overlapped_genes = {s: np.zeros(len(self.genes[s]), dtype=bool)
                                 for s in "+-"}
        self.overlapped_mrnas = {s: np.zeros(len(self.mrnas[s]), dtype=bool)
                                 for s in "+-"}
        self.overlapped_ltrs = np.zeros(len(self.ltrs), dtype=bool)
        self.finalized = True


class StreamEvaluator:
    """ref: stream_evaluator.c GtStreamEvaluator."""

    def __init__(self, nuceval: bool = True, evalLTR: bool = False,
                 LTRdelta: int = 20):
        self.nuceval = nuceval
        self.evalLTR = evalLTR
        self.LTRdelta = LTRdelta
        self.slots: dict[str, _Slot] = {}
        self.gene_eval = {lvl: Evaluator() for lvl in ("mRNA", "CDS")}
        self.mrna_eval = {lvl: Evaluator() for lvl in ("mRNA", "CDS")}
        self.ltr_eval = Evaluator()
        self.exon_eval = {lvl: TranscriptEvaluators()
                          for lvl in ("mRNA", "CDS")}
        self.exon_eval_collapsed = {lvl: TranscriptEvaluators()
                                    for lvl in ("mRNA", "CDS")}
        self.missing = {"genes": 0, "mRNAs": 0, "LTRs": 0}
        self.wrong = {"genes": 0, "mRNAs": 0, "LTRs": 0}
        self.nuc = {lvl: {"TP": 0, "FP": 0, "FN": 0}
                    for lvl in ("mRNA", "CDS")}

    # -- reality ------------------------------------------------------
    def add_reality(self, nodes: list[GenomeNode]) -> None:
        for node in nodes:
            if isinstance(node, RegionNode):
                if node.seqid not in self.slots:
                    self.slots[node.seqid] = _Slot(node.range, self.nuceval)
            elif isinstance(node, FeatureNode):
                slot = self.slots.get(node.seqid)
                if slot is None:
                    slot = _Slot(node.range, self.nuceval)
                    self.slots[node.seqid] = slot
                _determine_transcript_types(node)
                for fn in _traverse(node):
                    self._process_real(slot, fn)

    def _process_real(self, slot: _Slot, fn: FeatureNode) -> None:
        """ref: stream_evaluator.c:460 process_real_feature."""
        strand = fn.strand
        if fn.type == "gene":
            if strand in "+-":
                slot.genes[strand].append(fn)
        elif fn.type == "mRNA":
            if strand in "+-":
                slot.mrnas[strand].append(fn)
        elif fn.type == "LTR_retrotransposon":
            slot.ltrs.append(fn)
        elif fn.type in ("exon", "CDS"):
            lvl = "mRNA" if fn.type == "exon" else "CDS"
            if strand in "+-":
                slot.exons[(lvl, strand)].add(fn.range, _ttype(fn))
                if self.nuceval:
                    slot.set_nuc(slot.real_nuc[(lvl, strand)], fn.range)

    def _finalize_actuals(self) -> None:
        """ref: stream_evaluator.c:259 set_actuals_and_sort_them."""
        for slot in self.slots.values():
            for lvl in ("mRNA", "CDS"):
                self.gene_eval[lvl].A += (len(slot.genes["+"]) +
                                          len(slot.genes["-"]))
                self.mrna_eval[lvl].A += (len(slot.mrnas["+"]) +
                                          len(slot.mrnas["-"]))
            self.ltr_eval.A += len(slot.ltrs)
            for (lvl, _s), side in slot.exons.items():
                for c in _CATS:
                    self.exon_eval[lvl][c].A += len(side.raw[c])
            slot.finalize()
            for (lvl, _s), side in slot.exons.items():
                for c in _CATS:
                    self.exon_eval_collapsed[lvl][c].A += len(side.uniq[c])

    # -- prediction ---------------------------------------------------
    def add_prediction(self, nodes: list[GenomeNode]) -> None:
        if not any(s.finalized for s in self.slots.values()):
            self._finalize_actuals()
        import warnings
        for node in nodes:
            if not isinstance(node, FeatureNode):
                continue
            slot = self.slots.get(node.seqid)
            if slot is None:
                warnings.warn(f'sequence id "{node.seqid}" (with '
                              f"predictions) not given in reference")
                continue
            _determine_transcript_types(node)
            for fn in _traverse(node):
                self._process_predicted(slot, fn)

    def _process_predicted(self, slot: _Slot, fn: FeatureNode) -> None:
        """ref: stream_evaluator.c:992 process_predicted_feature."""
        strand = fn.strand
        rng = fn.range
        if fn.type == "gene":
            for lvl in ("mRNA", "CDS"):
                self.gene_eval[lvl].P += 1
            if strand in "+-":
                self._match_tree(slot, fn, slot.genes[strand],
                                 slot.true_genes, slot.overlapped_genes,
                                 self.gene_eval, _genes_are_equal, "genes")
        elif fn.type == "mRNA":
            for lvl in ("mRNA", "CDS"):
                self.mrna_eval[lvl].P += 1
            if strand in "+-":
                self._match_tree(slot, fn, slot.mrnas[strand],
                                 slot.true_mrnas, slot.overlapped_mrnas,
                                 self.mrna_eval, _mrnas_are_equal, "mRNAs")
        elif fn.type == "LTR_retrotransposon":
            self.ltr_eval.P += 1
            found = _bsearch_all(
                rng, slot.ltrs,
                lambda k, f: _range_cmp_delta(k, f.range, self.LTRdelta))
            if found:
                slot.overlapped_ltrs[found] = True
                for idx in found:
                    if not slot.true_ltrs[idx]:
                        slot.true_ltrs[idx] = True
                        self.ltr_eval.T += 1
                        break
            else:
                overlap = False
                for i, real in enumerate(slot.ltrs):
                    if rng.overlaps(real.range):
                        overlap = True
                        slot.overlapped_ltrs[i] = True
                if not overlap:
                    self.wrong["LTRs"] += 1
        elif fn.type in ("exon", "CDS"):
            lvl = "mRNA" if fn.type == "exon" else "CDS"
            cat = _ttype(fn)
            self.exon_eval[lvl]["all"].P += 1
            self.exon_eval[lvl][cat].P += 1
            # collapsed predicted: count each distinct range once per
            # strand bucket (unknown strands share the '-' bucket like
            # the reference's FORWARD test)
            ukey = (lvl, "+" if strand == "+" else "-")
            t = (rng.start, rng.end)
            for c in ("all", cat):
                if t not in slot.used[ukey][c]:
                    slot.used[ukey][c].add(t)
                    self.exon_eval_collapsed[lvl][c].P += 1
            if strand in "+-":
                side = slot.exons[(lvl, strand)]
                for c in ("all", cat):
                    self._determine_true_exon(side, c, t, lvl)
                if self.nuceval:
                    key = (lvl, strand)
                    out = slot.set_nuc(slot.pred_nuc[key], rng)
                    slot.FP_out_of_range[key] += out

    def _determine_true_exon(self, side: _ExonSide, cat: str, t, lvl):
        """ref: stream_evaluator.c:797 determine_true_exon."""
        found = _bsearch_all(t, side.uniq[cat],
                             lambda a, b: -1 if a < b else (1 if a > b else 0))
        if not found:
            return
        idx = found[0]
        if side.counts[cat][idx]:
            side.counts[cat][idx] -= 1
            self.exon_eval[lvl][cat].T += 1
        if not side.hit[cat][idx]:
            side.hit[cat][idx] = True
            self.exon_eval_collapsed[lvl][cat].T += 1

    def _match_tree(self, slot, fn, reals, true_tabs, overlapped, evals,
                    equal_func, kind):
        """Range-equal bsearch + structural equality, else overlap-based
        wrong-feature detection (ref: compare_features + the gene/mRNA
        branches of process_predicted_feature)."""
        strand = fn.strand
        found = _bsearch_all(fn.range, reals,
                             lambda k, f: _range_cmp(k, f.range))
        if found:
            overlapped[strand][found] = True
            for lvl, ftype in (("mRNA", "exon"), ("CDS", "CDS")):
                for idx in found:
                    if equal_func(fn, reals[idx], ftype):
                        if not true_tabs[lvl][strand][idx]:
                            true_tabs[lvl][strand][idx] = True
                            evals[lvl].T += 1
                            break
        else:
            overlap = False
            for i, real in enumerate(reals):
                if fn.range.overlaps(real.range):
                    overlap = True
                    overlapped[strand][i] = True
            if not overlap:
                self.wrong[kind] += 1

    # -- results ------------------------------------------------------
    def _finish(self) -> None:
        if not any(s.finalized for s in self.slots.values()) \
                and self.slots:
            self._finalize_actuals()
        for slot in self.slots.values():
            for s in "+-":
                self.missing["genes"] += int(
                    (~slot.overlapped_genes[s]).sum())
                self.missing["mRNAs"] += int(
                    (~slot.overlapped_mrnas[s]).sum())
            self.missing["LTRs"] += int((~slot.overlapped_ltrs).sum())
            if self.nuceval:
                for (lvl, s), real in slot.real_nuc.items():
                    pred = slot.pred_nuc[(lvl, s)]
                    self.nuc[lvl]["TP"] += int((real & pred).sum())
                    self.nuc[lvl]["FP"] += int((~real & pred).sum())
                    self.nuc[lvl]["FN"] += int((real & ~pred).sum())
                for (lvl, _s), fp in slot.FP_out_of_range.items():
                    self.nuc[lvl]["FP"] += fp

    def show(self) -> str:
        """ref: stream_evaluator.c:1560 gt_stream_evaluator_show."""
        self._finish()
        out = []
        if self.evalLTR:
            out.append(f"LTR_retrotransposon sensitivity: "
                       f"{self.ltr_eval.show_sensitivity()}"
                       f" (missing LTRs: {self.missing['LTRs']})")
            out.append(f"LTR_retrotransposon specificity: "
                       f"{self.ltr_eval.show_specificity()}"
                       f" (wrong LTRs: {self.wrong['LTRs']})")
            return "\n".join(out) + "\n"
        for lvl in ("mRNA", "CDS"):
            out.append(f"gene sensitivity ({lvl} level): "
                       f"{self.gene_eval[lvl].show_sensitivity()}"
                       f" (missing genes: {self.missing['genes']})")
            out.append(f"gene specificity ({lvl} level): "
                       f"{self.gene_eval[lvl].show_specificity()}"
                       f" (wrong genes: {self.wrong['genes']})")
        for lvl in ("mRNA", "CDS"):
            out.append(f"mRNA sensitivity ({lvl} level): "
                       f"{self.mrna_eval[lvl].show_sensitivity()}"
                       f" (missing mRNAs: {self.missing['mRNAs']})")
            out.append(f"mRNA specificity ({lvl} level): "
                       f"{self.mrna_eval[lvl].show_specificity()}"
                       f" (wrong mRNAs: {self.wrong['mRNAs']})")
        for lvl in ("mRNA", "CDS"):
            for te, extra in ((self.exon_eval[lvl], ""),
                              (self.exon_eval_collapsed[lvl], ", collapsed")):
                for c in _CATS:
                    out.append(
                        f"exon sensitivity ({lvl} level, {c}{extra}): "
                        f"{te[c].show_sensitivity()}")
                    out.append(
                        f"exon specificity ({lvl} level, {c}{extra}): "
                        f"{te[c].show_specificity()}")
        if self.nuceval:
            for lvl in ("mRNA", "CDS"):
                n = self.nuc[lvl]
                sens = (n["TP"] / (n["TP"] + n["FN"])
                        if n["TP"] or n["FN"] else 1.0)
                spec = (n["TP"] / (n["TP"] + n["FP"])
                        if n["TP"] or n["FP"] else 1.0)
                out.append(f"nucleotide sensitivity ({lvl} level): "
                           f"{sens * 100.0:6.2f}% (TP={n['TP']}/(TP="
                           f"{n['TP']} + FN={n['FN']}))")
                out.append(f"nucleotide specificity ({lvl} level): "
                           f"{spec * 100.0:6.2f}% (TP={n['TP']}/(TP="
                           f"{n['TP']} + FP={n['FP']}))")
        return "\n".join(out) + "\n"


def _check_sorted(nodes: list[GenomeNode], name: str) -> None:
    """Top-level features must be range-sorted per seqid (ref:
    gff3_in_stream_plain.c:63)."""
    last: dict[str, tuple] = {}
    for n in nodes:
        if not isinstance(n, FeatureNode):
            continue
        key = (n.range.start, n.range.end)
        if n.seqid in last and key < last[n.seqid]:
            raise ValueError(f"the file {name} is not sorted")
        last[n.seqid] = key


def evaluate(reality: list[GenomeNode], prediction: list[GenomeNode],
             nuceval: bool = True, evalLTR: bool = False,
             LTRdelta: int = 20, reality_name: str = "reality",
             prediction_name: str = "prediction") -> str:
    """gt eval reality prediction -> report text."""
    from .gff3 import add_missing_regions
    _check_sorted(reality, reality_name)
    _check_sorted(prediction, prediction_name)
    reality = add_missing_regions(reality)
    se = StreamEvaluator(nuceval=nuceval, evalLTR=evalLTR,
                         LTRdelta=LTRdelta)
    se.add_reality(reality)
    se.add_prediction(prediction)
    return se.show()
