"""Deterministic, resumable synthetic data pipeline.

A copy of ``src/repro/training/data.py`` (numpy only), so the port's
batches are byte-identical to the reference's.

Stateless index-based generation: batch ``i`` is a pure function of
(seed, i), so restart-after-failure resumes exactly (no shard state to
persist beyond the step counter). Shards along the data axis by slicing the
global batch — each host generates only its shard in a multi-host setup.

Sequences are Zipf-ish token streams with enough autocorrelation that CE
loss decreases during the smoke-training examples (pure uniform noise has
no learnable signal).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.3


class SyntheticLM:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        base = np.random.default_rng(cfg.seed)
        v = cfg.vocab_size
        # fixed bigram transition structure => learnable signal
        self._shift = base.integers(1, v, size=v)
        ranks = np.arange(1, v + 1, dtype=np.float64)
        probs = ranks ** (-cfg.zipf_a)
        self._probs = probs / probs.sum()

    def batch(self, step: int) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        v = cfg.vocab_size
        first = rng.choice(v, size=(cfg.global_batch,), p=self._probs)
        toks = np.empty((cfg.global_batch, cfg.seq_len + 1), np.int32)
        toks[:, 0] = first
        noise = rng.random((cfg.global_batch, cfg.seq_len))
        for t in range(cfg.seq_len):
            nxt = self._shift[toks[:, t]]
            resample = noise[:, t] < 0.15
            if resample.any():
                nxt = np.where(resample,
                               rng.choice(v, size=cfg.global_batch,
                                          p=self._probs), nxt)
            toks[:, t + 1] = nxt
        return {"tokens": toks}

    def shard(self, step: int, shard_idx: int, num_shards: int) -> dict:
        b = self.batch(step)
        per = self.cfg.global_batch // num_shards
        return {k: v[shard_idx * per:(shard_idx + 1) * per]
                for k, v in b.items()}
