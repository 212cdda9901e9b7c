"""Deterministic, shardable, checkpointable synthetic data pipeline.

Batches are a pure function of (seed, step, shard) via counter-based Philox
streams, so:
  - replay is bit-exact (Kishu's fallback recomputation relies on the data
    state being a versioned leaf in the namespace — §5.3),
  - each data-parallel host generates only its shard (no host-0 broadcast),
  - resuming from a checkpointed ``DataState`` continues the exact stream,
    on *any* mesh shape (elastic restart: the stream is keyed by global
    example index, not by host).

The token distribution is a Zipf-like mixture with injected n-gram structure
so losses actually decrease during example runs (pure-uniform tokens give a
flat loss and make end-to-end tests meaningless).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np


@dataclass(frozen=True)
class DataState:
    seed: int
    step: int

    def as_tree(self) -> Dict[str, int]:
        return {"seed": int(self.seed), "step": int(self.step)}

    @classmethod
    def from_tree(cls, t) -> "DataState":
        return cls(seed=int(t["seed"]), step=int(t["step"]))


class TokenPipeline:
    def __init__(self, vocab_size: int, global_batch: int, seq_len: int, *,
                 n_hosts: int = 1, host_id: int = 0):
        assert global_batch % n_hosts == 0
        self.vocab = vocab_size
        self.global_batch = global_batch
        self.local_batch = global_batch // n_hosts
        self.seq = seq_len
        self.n_hosts = n_hosts
        self.host_id = host_id

    def _example(self, seed: int, index: int) -> np.ndarray:
        """One (seq+1,) token stream keyed by global example index."""
        rng = np.random.Generator(np.random.Philox(key=seed, counter=index))
        # Zipf-ish marginal
        z = rng.zipf(1.3, size=self.seq + 1)
        toks = (z - 1) % self.vocab
        # inject deterministic bigram structure: with p=0.5, next = f(prev)
        follow = rng.random(self.seq + 1) < 0.5
        prev = np.roll(toks, 1)
        toks = np.where(follow, (prev * 31 + 7) % self.vocab, toks)
        return toks.astype(np.int32)

    def batch_at(self, state: DataState) -> Dict[str, np.ndarray]:
        """Deterministic local batch for ``state`` (host's shard only)."""
        base = state.step * self.global_batch + self.host_id * self.local_batch
        toks = np.stack([self._example(state.seed, base + i)
                         for i in range(self.local_batch)])
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def next_batch(self, state: DataState
                   ) -> Tuple[Dict[str, np.ndarray], DataState]:
        return self.batch_at(state), DataState(state.seed, state.step + 1)
