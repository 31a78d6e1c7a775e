"""Karlin-Altschul statistics: evalues and bit scores for matches.

The port's copy of ``genometools_tpu/match/karlin_altschul.py``
(JAX-free host code; the port imports nothing of the reference
package).

Capability equivalent of the reference karlin_altschul_stat
(ref: src/match/karlin_altschul_stat.c). The gapped path uses the same
precomputed BLASTN parameter vectors; searchspace applies the BLAST
length adjustment (ref: gt_evalue_length_adjustment).

Validated against the reference's own unit-test constants
(ref: karlin_altschul_stat.c gt_evalue_unit_test: searchspace 308243802
for query 450 over db 770425/1952 seqs, evalue 6.148125e-148 for 300
matches...).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

# (gapscore, lambda, K, H, alpha, beta) per (matchscore, mismatchscore)
# ref: karlin_altschul_stat.c ga_vector_* tables
_GA_VECTORS = {
    (1, -1): (-2, 1.26, 0.43, 0.90, 1.4, -1),   # ga_vector_1_4 comment 1,-4?
    (1, -4): (-2, 1.26, 0.43, 0.90, 1.4, -1),
    (2, -7): (-4, 0.63, 0.43, 0.90, 0.7, -1),
    (1, -3): (-2, 1.25, 0.42, 0.83, 1.5, -2),
    (2, -5): (-4, 0.62, 0.39, 0.78, 0.8, -2),
    (1, -2): (-2, 1.19, 0.34, 0.66, 1.8, -3),
    (2, -3): (-4, 0.55, 0.21, 0.46, 1.2, -5),
}


@dataclass
class KarlinAltschulStat:
    lambda_: float
    K: float
    H: float
    alpha_div_lambda: float
    beta: float
    matchscore: int
    mismatchscore: int
    gapscore: int
    actual_length_db: int = 0
    num_of_db_seqs: int = 0

    @property
    def logK(self) -> float:
        return math.log(self.K)

    @classmethod
    def new_gapped(cls, total_length_db: int, num_of_db_seqs: int,
                   matchscore: int = 1, mismatchscore: int = -2
                   ) -> "KarlinAltschulStat":
        """ref: gt_karlin_altschul_stat_new_gapped — scorehandler
        (1,-2,0,-2), db length corrected by the separators."""
        gap, lam, K, H, alpha, beta = _GA_VECTORS[(matchscore, mismatchscore)]
        actual = total_length_db - (num_of_db_seqs - 1)
        return cls(lam, K, H, alpha / lam, beta, matchscore, mismatchscore,
                   gap, actual, num_of_db_seqs)

    # -- searchspace with BLAST length adjustment --------------------------
    def length_adjustment(self, query_length: int) -> int:
        """ref: gt_evalue_length_adjustment."""
        K = self.K
        logK = self.logK
        alpha_div_lambda = self.alpha_div_lambda
        beta = self.beta
        n = self.actual_length_db
        N = self.num_of_db_seqs
        m = query_length
        space = n * m - max(m, n) / K
        if space < 0:
            return 0
        nNm = m * N + n
        len_max = 2 * space / (nNm + math.sqrt(nNm * nNm - 4 * N * space))
        len_next = 0.0
        len_bound = 0.0
        converged = False
        for _ in range(20):
            length = len_next
            len_bar = beta + alpha_div_lambda * (
                logK + math.log((m - length) * (n - N * length)))
            if len_bar >= length:
                len_bound = length
                if len_bar - len_bound <= 1.0:
                    converged = True
                    break
                if length == len_max:
                    break
            len_next = min(len_bar, len_max)
        if converged:
            length = int(len_bound)
            len_bar = beta + alpha_div_lambda * (
                logK + math.log((m - length) * (n - N * length)))
            if len_bar >= length + 1:
                length += 1
            return length
        return int(len_bound)

    def searchspace(self, query_idealen: int) -> int:
        """ref: gt_evalue_searchspace."""
        adj = self.length_adjustment(query_idealen)
        return (query_idealen - adj) * \
            (self.actual_length_db - self.num_of_db_seqs * adj)

    # -- evalue / bitscore -------------------------------------------------
    def raw_score(self, matches: int, mismatches: int, indels: int) -> int:
        return matches * self.matchscore + mismatches * self.mismatchscore \
            + indels * self.gapscore

    def evalue_from_raw_score(self, raw: int, searchspace: int) -> float:
        return searchspace * math.exp(-self.lambda_ * raw + self.logK)

    def evalue(self, matches: int, mismatches: int, indels: int,
               searchspace: int) -> float:
        return self.evalue_from_raw_score(
            self.raw_score(matches, mismatches, indels), searchspace)

    def bit_score(self, matches: int, mismatches: int, indels: int) -> float:
        raw = self.raw_score(matches, mismatches, indels)
        return (self.lambda_ * raw - self.logK) / math.log(2)


def evalue_for_match(ka: KarlinAltschulStat, query_seqlen: int,
                     aligned_len: int, distance: int, mismatches: int
                     ) -> tuple[float, float]:
    """(evalue, bit_score) for a match record
    (ref: gt_querymatch_evalue_bit_score_generic)."""
    matches = (aligned_len - distance - mismatches) // 2
    indels = distance - mismatches
    ss = ka.searchspace(query_seqlen)
    return (ka.evalue(matches, mismatches, indels, ss),
            ka.bit_score(matches, mismatches, indels))
