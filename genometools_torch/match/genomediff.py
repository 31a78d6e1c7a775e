"""genomediff: pairwise Kr divergence via shortest unique substring
lengths (shulen).

The port's counterpart of ``genometools_tpu/match/genomediff.py``
(`gt genomediff`, ref: src/match/shu-genomediff.c, esa-shulen.c,
shu-divergence.c): for every ordered genome pair (i, j), the average
shulen (the length of the shortest prefix of each position's suffix in
genome i that is NOT a substring of genome j, i.e. the longest common
prefix with any j-suffix plus one) yields the divergence estimate and
the Jukes-Cantor-corrected Kr distance.

The reference builds one ESA per subject genome and walks it once per
query position (a binary search from depth 0). Here the texts are
joined, separated, into one text whose ESA ``build_esa`` sorts on
`device`; a suffix's longest match in text j is then its LCP with the
nearest suffix of text j above or below it in suffix order, the minimum
of the LCP table between them (two segmented running minima over the
table per subject text). Specials have keys of their own, so a match
never crosses one, as the reference's search stops at them. The sums
are the reference's; the divergence solver is its host code, copied.
"""

from __future__ import annotations

import math

import numpy as np

from ..core.chardef import SEPARATOR
from ..core.encseq import Encseq
from ..index.esa import build_esa


def _nearest_lcp(lcp: np.ndarray, subject: np.ndarray) -> np.ndarray:
    """Per suftab slot, the LCP of its suffix with the nearest slot
    flagged in `subject` above or below it (the longest common prefix
    with any of those suffixes; 0 when there is none)."""
    m = lcp.size
    lcp = lcp.astype(np.int64)
    inf = int(lcp.max()) + 1 if m else 1
    big = inf + 1

    def since_last(v, flag):
        # running minimum of v since the last flagged slot (itself
        # excluded); the offsets keep earlier segments out of the min
        seg = np.cumsum(flag)
        run = np.minimum.accumulate(np.where(flag, inf, v) - seg * big)
        return np.where(seg > 0, run + seg * big, 0)

    left = since_last(lcp, subject)            # min lcp[p+1 .. i]
    after = np.zeros(m, np.int64)
    after[:-1] = lcp[1:]                       # lcp with the next slot
    right = since_last(after[::-1], subject[::-1])[::-1]   # lcp[i+1 .. q]
    return np.maximum(left, right)


def shulen_sums(texts: list[np.ndarray], subjects, alphabet,
                device="cuda") -> np.ndarray:
    """sums[i, j] for every text i != j and every j in `subjects`: the
    sum over the regular positions of text i of (the longest prefix of
    text i's suffix there that occurs in text j) + 1 (ref: esa-shulen.c
    gt_multiesa2shulengthdist). A text's suffix ends at its own end; one
    ESA of all texts, sorted on `device`."""
    lens = np.asarray([t.size for t in texts], np.int64)
    starts = np.cumsum(lens + 1) - (lens + 1)
    total = int(lens.sum()) + len(texts) - 1
    codes = np.full(total, SEPARATOR, np.uint8)
    owner = np.full(total + 1, -1, np.int64)   # the sentinel owns nothing
    for i, t in enumerate(texts):
        codes[starts[i]:starts[i] + t.size] = t
        owner[starts[i]:starts[i] + t.size] = i
    ssp = np.flatnonzero(codes == SEPARATOR)
    enc = Encseq(codes, ssp, [""] * (ssp.size + 1), alphabet)
    esa = build_esa(enc, with_lcp=True, device=device)
    sa = np.asarray(esa.suftab, np.int64)
    own = owner[sa]
    regular = np.concatenate([codes, [SEPARATOR]])[sa] < 4
    sums = np.zeros((len(texts), len(texts)), np.int64)
    for j in subjects:
        ms = _nearest_lcp(esa.lcptab, own == j) + 1
        q = regular & (own >= 0) & (own != j)
        sums[:, j] = np.bincount(own[q], weights=ms[q],
                                 minlength=len(texts)).astype(np.int64)
    return sums


def shulen_sum(subject: Encseq, query_codes: np.ndarray,
               device="cuda") -> int:
    """Sum over query positions of (longest match in subject) + 1,
    skipping wildcard/separator start positions
    (ref: esa-shulen.c gt_multiesa2shulengthdist)."""
    return int(shulen_sums([subject.codes, np.asarray(query_codes)], [0],
                           subject.alphabet, device)[1, 0])


def average_shulen(subject: Encseq, query_codes: np.ndarray,
                   device="cuda") -> float:
    """Mean over query positions of (longest match in subject) + 1
    (ref: gt_esa_shulen / shu-dfs: shulen = lcp with subject + 1)."""
    count = int(np.sum(np.asarray(query_codes) < 4))
    return shulen_sum(subject, query_codes, device) / max(count, 1)


def _pmax_factory(p: float, subject_length: int):
    """Probability that the shulen at a position is <= x under the
    null model (ref: shu-divergence.c:42 pmax), memoized per x."""
    from math import lgamma

    cache: dict[int, float] = {}

    def lnchoose(x, k):
        if k == 0 or k == x:
            return 0.0
        return lgamma(x + 1) - lgamma(k + 1) - lgamma(x - k + 1)

    def pmax(x: int) -> tuple[float, bool]:
        hit = cache.get(x)
        if hit is not None:
            return hit, False
        s = 0.0
        reached = False
        for k in range(x + 1):
            m = (2.0 ** x) * (p ** k) * ((0.5 - p) ** (x - k)) * \
                (1.0 - (p ** k) * ((0.5 - p) ** (x - k))) ** subject_length
            if m > 0.0:
                s += math.exp(math.log(m) + lnchoose(x, k))
            if s >= 1.0:
                s = 1.0
                reached = True
                break
        cache[x] = s
        return s, reached

    return pmax


def _exp_shulen(d: float, p: float, subject_length: int, pmax,
                abs_err: float = 1e-5) -> float:
    """Expected average shulen for divergence d
    (ref: shu-divergence.c:104 expShulen)."""
    e = 0.0
    t = 1.0 - d
    p_t = t
    prob_old = 0.0
    threshold_reached = False
    for i in range(1, subject_length):
        factor = 1.0 - p_t
        if not threshold_reached:
            s, reached = pmax(i)
            if reached:
                threshold_reached = True
            prob_i = factor * s
        else:
            prob_i = factor
        delta = (prob_i - prob_old) * i
        e += delta
        if e >= 1.0 and delta / e <= abs_err:
            break
        p_t *= t
        prob_old = prob_i
    return e


def divergence(avg_shulen: float, subject_length: int, gc: float,
               rel_err: float = 1e-3, abs_err: float = 1e-5,
               threshold: float = 1e-9) -> float:
    """Exact divergence solver: bisection on d so that the model's
    expected shulen matches the observation
    (ref: shu-divergence.c:131 gt_divergence; defaults from
    tools/gt_genomediff.c -thr/-abs_err/-rel_err)."""
    p = gc / 2.0
    q = (1.0 - gc) / 2.0
    pmax = _pmax_factory(p, subject_length)
    du = 0.0
    dl = 1.0 - (2 * p * p + 2 * q * q)
    while threshold < (dl - du) / 2.0:
        dm = (du + dl) / 2.0
        exp_shulen = _exp_shulen(dm, p, subject_length, pmax, abs_err)
        if avg_shulen < exp_shulen:
            du = dm
        else:
            dl = dm
        if dl > 0 and abs(dl - du) / dl <= rel_err:
            break
    return (du + dl) / 2.0


def kr_distance(d: float) -> float:
    """Jukes-Cantor correction (ref: gt_calculateKr):
    Kr = -3/4 * ln(1 - 4/3 d)."""
    d = min(d, 0.7499999)
    return -0.75 * math.log(1.0 - (4.0 / 3.0) * d)


def genomediff(genomes: list[Encseq], mirrored: bool = True,
               device="cuda"):
    """Pairwise shulen-sum and Kr matrices over genome encseqs
    (ref: shu-genomediff.c; the tool indexes both strands via
    -mirrored, scripts/genomediff.rb esa_index): returns (sums, kr)
    with sums[i][j] = total shulen of genome i's positions against
    genome j's index, all of them from one ESA sorted on `device`."""
    gs = [g.mirror() for g in genomes] if mirrored else genomes
    n = len(gs)
    lengths = [int(np.sum(g.codes < 4)) for g in gs]
    gcs = [float(np.sum((g.codes == 1) | (g.codes == 2)) /
                 max(np.sum(g.codes < 4), 1)) for g in gs]
    sums = shulen_sums([g.codes for g in gs], range(n), gs[0].alphabet,
                       device) if n > 1 else np.zeros((n, n), np.int64)
    avg = np.zeros((n, n))
    for i in range(n):
        for j in range(n):
            if i != j:
                avg[i, j] = sums[i, j] / lengths[i]
    kr = np.zeros((n, n))
    for i in range(n):
        for j in range(i + 1, n):
            # query = smaller avg shulen; ties pick the gc farther
            # from 0.5 (ref: shu-genomediff.c:190)
            if avg[i, j] < avg[j, i]:
                query, subject = i, j
            elif avg[j, i] < avg[i, j]:
                query, subject = j, i
            elif abs(gcs[i] - 0.5) < abs(gcs[j] - 0.5):
                query, subject = j, i
            else:
                query, subject = i, j
            d = divergence(avg[query, subject], lengths[subject],
                           gcs[query])
            kr[i, j] = kr[j, i] = kr_distance(d)
    return sums, kr
