"""Deterministic, sharded, resumable token stream (the port's copy of
``repro.data.loader``, numpy only).

  * batch content is a pure function of (seed, step): a restarted node
    computes exactly the batches it needs (skip-ahead resume is O(1));
  * each host materializes only its slice of the global batch
    (host_index / host_count);
  * batches for steps [s, s + prefetch) are generated ahead on a bounded
    deque.

State = {"seed", "step"}, two ints, checkpointed in meta.json.
"""
from __future__ import annotations

from collections import deque

import numpy as np

from .synthetic import token_batch


class TokenStream:
    def __init__(self, *, vocab: int, batch: int, seq_len: int,
                 seed: int = 0, step: int = 0, host_index: int = 0,
                 host_count: int = 1, prefetch: int = 2):
        if batch % host_count:
            raise ValueError(f"TokenStream: batch {batch} does not split "
                             f"over {host_count} hosts")
        self.vocab, self.batch, self.seq = vocab, batch, seq_len
        self.seed = seed
        self.step = step
        self.host_index, self.host_count = host_index, host_count
        self.prefetch = prefetch
        self._q: deque = deque()

    # -- iteration ----------------------------------------------------------

    def _make(self, step: int) -> np.ndarray:
        full = token_batch(step, self.batch, self.seq + 1, self.vocab,
                           self.seed)
        per = self.batch // self.host_count
        lo = self.host_index * per
        return full[lo:lo + per]

    def next(self) -> np.ndarray:
        """The (batch / host_count, seq_len + 1) int32 tokens of the next
        step."""
        while len(self._q) < self.prefetch:
            self._q.append((self.step + len(self._q),
                            self._make(self.step + len(self._q))))
        s, b = self._q.popleft()
        if s != self.step:
            raise RuntimeError(f"TokenStream: queued step {s}, expected "
                               f"{self.step}")
        self.step += 1
        return b

    # -- checkpoint integration ----------------------------------------------

    def state(self) -> dict:
        return {"seed": self.seed, "step": self.step}

    @classmethod
    def from_state(cls, state: dict, **kw):
        return cls(seed=state["seed"], step=state["step"], **kw)
