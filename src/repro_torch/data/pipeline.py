"""Deterministic synthetic token pipeline (a copy of the JAX package's
``data/pipeline.py``: numpy only, so its batches equal JAX's bit for bit).

Generates a reproducible structured token stream (Zipfian unigrams +
repeated n-gram motifs so the LM loss actually decreases during the example
training run) and yields fixed-shape batches, shardable over the data axis.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_alpha: float = 1.2
    motif_len: int = 8
    n_motifs: int = 64
    motif_prob: float = 0.5


class SyntheticTokens:
    """Infinite iterator of {"tokens": (B, S+1) int32} batches."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        p = ranks ** (-cfg.zipf_alpha)
        self._p = p / p.sum()
        self._motifs = rng.integers(
            0, cfg.vocab_size, size=(cfg.n_motifs, cfg.motif_len),
            dtype=np.int64)
        self._step = 0

    def _sample_doc(self, rng: np.random.Generator, n: int) -> np.ndarray:
        out = np.empty(n + self.cfg.motif_len, dtype=np.int64)
        i = 0
        while i < n:
            if rng.random() < self.cfg.motif_prob:
                m = self._motifs[rng.integers(self.cfg.n_motifs)]
                out[i:i + self.cfg.motif_len] = m
                i += self.cfg.motif_len
            else:
                out[i] = rng.choice(self.cfg.vocab_size, p=self._p)
                i += 1
        return out[:n]

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, self._step))
        self._step += 1
        toks = np.stack([self._sample_doc(rng, cfg.seq_len + 1)
                         for _ in range(cfg.global_batch)])
        return {"tokens": toks.astype(np.int32)}


def prompt_tokens(vocab_size: int, length: int, seed: int) -> np.ndarray:
    """A deterministic synthetic prompt (workload generator helper)."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab_size, size=(length,), dtype=np.int32)
