"""Deterministic synthetic datasets (no downloads): copies of the numpy
functions of ``repro.data.synthetic`` (the reference module imports jax).
Each gives the reference's arrays byte for byte from the same seed.

The classification sets are *learnable* (class-conditional structure), so
accuracy curves behave like the paper's MNIST/News20 workloads: hyper-
parameters genuinely change convergence, which the HPT experiments need.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np


def make_image_dataset(seed: int, n: int, n_classes: int = 10, size: int = 28,
                       noise: float = 0.35):
    """MNIST-like: smooth class prototypes + pixel noise. Returns numpy dict."""
    rng = np.random.RandomState(seed)
    # smooth prototypes: random low-frequency patterns per class
    freq = rng.randn(n_classes, 4, 4)
    protos = np.zeros((n_classes, size, size), np.float32)
    xs = np.linspace(0, 2 * np.pi, size)
    for c in range(n_classes):
        for i in range(4):
            for j in range(4):
                protos[c] += freq[c, i, j] * np.outer(
                    np.sin((i + 1) * xs / 2), np.cos((j + 1) * xs / 2))
    protos /= np.abs(protos).max(axis=(1, 2), keepdims=True)
    labels = rng.randint(0, n_classes, n).astype(np.int32)
    images = protos[labels] + noise * rng.randn(n, size, size).astype(np.float32)
    return {"images": images[..., None].astype(np.float32), "labels": labels}


def make_text_dataset(seed: int, n: int, n_classes: int = 20,
                      vocab: int = 4096, seq_len: int = 128,
                      signal: float = 0.4):
    """News20-like: class-specific token distributions over a zipf background."""
    rng = np.random.RandomState(seed)
    base = 1.0 / (np.arange(vocab) + 10.0)
    base /= base.sum()
    toks = np.empty((n, seq_len), np.int32)
    labels = rng.randint(0, n_classes, n).astype(np.int32)
    class_tokens = rng.randint(0, vocab, (n_classes, 32))
    for i in range(n):
        t = rng.choice(vocab, seq_len, p=base)
        k = int(signal * seq_len)
        pos = rng.choice(seq_len, k, replace=False)
        t[pos] = rng.choice(class_tokens[labels[i]], k)
        toks[i] = t
    return {"tokens": toks, "labels": labels}


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


@dataclasses.dataclass
class Batches:
    """Deterministic, shardable batch iterator with epoch semantics.

    Shuffles per-epoch with a seed derived from (base_seed, epoch) so any
    restart (fault recovery) reproduces the exact same stream — checkpoint
    stores only (epoch, batch_index).
    """
    data: Dict[str, np.ndarray]
    batch_size: int
    seed: int = 0
    drop_remainder: bool = True

    def __post_init__(self):
        self.n = len(next(iter(self.data.values())))

    def epoch(self, epoch_idx: int, start_batch: int = 0
              ) -> Iterator[Dict[str, np.ndarray]]:
        rng = np.random.RandomState((self.seed * 1000003 + epoch_idx) % 2**31)
        order = rng.permutation(self.n)
        nb = self.n // self.batch_size
        for b in range(start_batch, nb):
            idx = order[b * self.batch_size:(b + 1) * self.batch_size]
            yield {k: v[idx] for k, v in self.data.items()}

    @property
    def batches_per_epoch(self) -> int:
        return self.n // self.batch_size


def train_test_split(data: Dict[str, np.ndarray], test_frac=0.2, seed=0):
    n = len(next(iter(data.values())))
    rng = np.random.RandomState(seed)
    order = rng.permutation(n)
    k = int(n * (1 - test_frac))
    tr = {k2: v[order[:k]] for k2, v in data.items()}
    te = {k2: v[order[k:]] for k2, v in data.items()}
    return tr, te
