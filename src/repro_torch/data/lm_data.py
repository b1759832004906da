"""Deterministic, resumable synthetic LM data pipeline.

A Zipf-token Markov-chain corpus: enough structure that cross-entropy
drops well below the unigram entropy (so training curves are meaningful),
fully deterministic from (seed, cursor) so checkpoint resume is bitwise.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class LMDataState:
    seed: int
    cursor: int          # number of batches already served


class SyntheticLM:
    """Markov bigram sampler with Zipf marginals."""

    def __init__(self, vocab_size: int, branching: int = 8, seed: int = 0):
        self.vocab = vocab_size
        rng = np.random.default_rng(seed ^ 0x5EED)
        # each token can transition to `branching` successors
        self.succ = rng.integers(0, vocab_size, size=(vocab_size, branching))
        probs = 1.0 / np.arange(1, vocab_size + 1)
        self.marginal = probs / probs.sum()
        self.seed = seed

    def batch(self, state: LMDataState, batch_size: int, seq_len: int):
        rng = np.random.default_rng((state.seed << 20) ^ state.cursor)
        toks = np.empty((batch_size, seq_len + 1), dtype=np.int32)
        toks[:, 0] = rng.choice(self.vocab, size=batch_size, p=self.marginal)
        choices = rng.integers(0, self.succ.shape[1],
                               size=(batch_size, seq_len))
        resets = rng.random((batch_size, seq_len)) < 0.05
        fresh = rng.choice(self.vocab, size=(batch_size, seq_len),
                           p=self.marginal)
        for t in range(seq_len):
            nxt = self.succ[toks[:, t], choices[:, t]]
            toks[:, t + 1] = np.where(resets[:, t], fresh[:, t], nxt)
        new_state = LMDataState(seed=state.seed, cursor=state.cursor + 1)
        return {"inputs": toks[:, :-1], "labels": toks[:, 1:]}, new_state
