"""Deterministic synthetic token stream: a copy of the reference's
``repro.data.synthetic.make_lm_dataset`` (numpy only; the reference module
imports jax)."""
from __future__ import annotations

import numpy as np


def make_lm_dataset(seed: int, n_tokens: int, vocab: int):
    """Markov-chain token stream (learnable bigram structure)."""
    rng = np.random.RandomState(seed)
    state = rng.randint(vocab)
    shift = rng.randint(1, vocab, size=64)
    toks = np.empty(n_tokens, np.int32)
    for i in range(n_tokens):
        toks[i] = state
        state = int((state + shift[state % 64]) % vocab) if rng.rand() < 0.8 \
            else rng.randint(vocab)
    return toks
