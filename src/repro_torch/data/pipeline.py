"""Deterministic, resumable, shard-aware synthetic token pipeline
(counterpart of ``repro.data.pipeline``).

Every batch is a pure function of (seed, step, shard).  The token stream is
a fixed random first-order Markov chain over the vocabulary (each token has
``branching`` successors), mixed with uniform noise, so small models show a
falling loss.  The successor table comes from numpy's ``default_rng(seed)``
exactly as in ``repro``, so it is the same table in both packages; the walk
draws from a ``torch.Generator`` (``repro`` draws with jax's threefry), so
the batches differ between the packages and the tests feed ``repro``'s.
The batches are made on the host, int32 as ``repro``'s; the train step
moves them to the card.  ``media_stub`` draws a vlm's stub media
embeddings, f32 normals from a generator seeded by (seed + 7, step, shard),
as ``repro`` seeds its key; its draws differ from ``repro``'s too.
"""

from __future__ import annotations

import numpy as np
import torch

#: mixes (seed, step, shard) into one generator seed
_MIX = 0x9E3779B97F4A7C15


class SyntheticLM:
    def __init__(self, vocab_size: int, seq_len: int, global_batch: int, *, seed: int = 0,
                 branching: int = 4, noise: float = 0.05):
        self.vocab_size = vocab_size
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.seed = seed
        self.noise = noise
        self.branching = branching
        rng = np.random.default_rng(seed)
        self._succ = torch.from_numpy(
            rng.integers(0, vocab_size, (vocab_size, branching)).astype(np.int32))

    def batch(self, step: int, *, shard: int = 0, num_shards: int = 1) -> dict:
        """Global batch slice for ``shard`` of ``num_shards`` at ``step``:
        ``{"tokens": int32 [global_batch / num_shards, seq_len]}``."""
        if self.global_batch % num_shards:
            raise ValueError(f"global batch {self.global_batch} does not divide into "
                             f"{num_shards} shards")
        b, S, V = self.global_batch // num_shards, self.seq_len, self.vocab_size
        gen = torch.Generator()
        gen.manual_seed(((self.seed * _MIX + step) * _MIX + shard) % (1 << 63))
        tok = torch.randint(0, V, (b,), generator=gen)
        choices = torch.randint(0, self.branching, (S, b), generator=gen)
        noise_tok = torch.randint(0, V, (S, b), generator=gen)
        noisy = torch.rand((S, b), generator=gen) < self.noise
        seq = torch.empty((S, b), dtype=torch.int32)
        for t in range(S):
            tok = torch.where(noisy[t], noise_tok[t], self._succ[tok, choices[t]].to(torch.int64))
            seq[t] = tok
        return {"tokens": seq.T.contiguous()}

    def media_stub(self, step: int, num_tokens: int, media_d: int, *, shard: int = 0,
                   num_shards: int = 1) -> torch.Tensor:
        """A vlm's stub media embeddings for ``shard`` of ``num_shards`` at
        ``step``: f32 [global_batch / num_shards, num_tokens, media_d]
        standard normals on the host."""
        if self.global_batch % num_shards:
            raise ValueError(f"global batch {self.global_batch} does not divide into "
                             f"{num_shards} shards")
        gen = torch.Generator()
        gen.manual_seed((((self.seed + 7) * _MIX + step) * _MIX + shard) % (1 << 63))
        b = self.global_batch // num_shards
        return torch.randn((b, num_tokens, media_d), generator=gen, dtype=torch.float32)
