"""Token data pipeline for the LM zoo's training path.

Port copy of the JAX package's ``data/tokens.py`` (numpy only; the port
keeps its own copy). Batches are synthesized from a seeded numpy
generator, structured enough that the loss decreases: Zipf-distributed
unigrams with copy patterns, so a model can learn local statistics. Both
packages yield the same arrays for the same arguments.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class TokenStream:
    """Endless synthetic token batches for the LM workload: Zipf-distributed
    ids with injected copy structure, yielded as (batch_size, seq_len)
    input/target dicts. Deterministic per `seed`."""

    vocab_size: int
    seq_len: int
    batch_size: int
    seed: int = 0

    def __iter__(self):
        rng = np.random.default_rng(self.seed)
        zipf_p = 1.0 / np.arange(1, self.vocab_size + 1) ** 1.1
        zipf_p /= zipf_p.sum()
        while True:
            base = rng.choice(self.vocab_size, p=zipf_p,
                              size=(self.batch_size, self.seq_len))
            # inject copy structure: second half repeats first half shifted
            half = self.seq_len // 2
            base[:, half:half * 2] = base[:, :half]
            yield {"tokens": base.astype(np.int32),
                   "labels": np.roll(base, -1, axis=1).astype(np.int32)}


def synthetic_token_batches(vocab_size: int, seq_len: int, batch_size: int,
                            num_batches: int, seed: int = 0):
    it = iter(TokenStream(vocab_size, seq_len, batch_size, seed))
    return [next(it) for _ in range(num_batches)]
