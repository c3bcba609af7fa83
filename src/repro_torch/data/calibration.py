"""Calibration tokens: the port's own deterministic synthetic corpus.

Same construction as the reference's ``data/synthetic.SyntheticCorpus``
(offline, no WikiText): a Zipf(alpha) unigram stream made learnable by a
second-order Markov step through fixed random permutations, with token 0
declaring a topic that selects the permutation table, so every position
must attend to the sequence start.  Draws come from ``torch.Generator``s,
so the tokens differ from the reference's ``jax.random`` draws for the same
seed; parity tests hand the port the reference's tokens instead.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import generator


@dataclasses.dataclass(frozen=True)
class SyntheticCorpus:
    vocab_size: int
    seed: int = 0
    alpha: float = 1.2
    markov_strength: float = 0.75  # fraction of positions made predictable
    n_topics: int = 4  # topic (token 0) selects the transition table

    def _perms(self):
        g = generator(self.seed + 1)
        n_t = max(self.n_topics, 1)
        p1 = torch.stack([torch.randperm(self.vocab_size, generator=g)
                          for _ in range(n_t)])
        return p1, torch.randperm(self.vocab_size, generator=g)

    def sample(self, gen: torch.Generator, batch: int, seq_len: int
               ) -> torch.Tensor:
        """(batch, seq_len) int64 tokens on the CPU, deterministic in
        (seed, gen's state).  Ids 0/1 are reserved; topics are 2..."""
        v = self.vocab_size
        ranks = torch.arange(1, max(v - 2, 1) + 1, dtype=torch.float64)
        probs = ranks ** -self.alpha
        base = torch.multinomial(probs / probs.sum(), batch * seq_len,
                                 replacement=True, generator=gen)
        base = (base + 2).reshape(batch, seq_len)
        keep = torch.rand((batch, seq_len), generator=gen) < (
            1.0 - self.markov_strength)
        topic = torch.randint(0, max(self.n_topics, 1), (batch,),
                              generator=gen)
        p1, p2 = self._perms()
        out = torch.empty((batch, seq_len), dtype=torch.int64)
        out[:, 0] = topic + 2
        t1 = t2 = out[:, 0]
        for t in range(1, seq_len):
            det = (p1[topic, t1] + p2[t2]) % v
            tok = torch.where(keep[:, t], base[:, t], det)
            out[:, t] = tok
            t1, t2 = tok, t1
        return out


def calibration_set(vocab_size: int, n_samples: int, seq_len: int,
                    seed: int = 0) -> torch.Tensor:
    """(n_samples, seq_len) int64 calibration tokens (CPU)."""
    corpus = SyntheticCorpus(vocab_size=vocab_size, seed=seed)
    return corpus.sample(generator(seed), n_samples, seq_len)


def heldout_set(vocab_size: int, n_samples: int, seq_len: int,
                seed: int = 0) -> torch.Tensor:
    """Held-out tokens from the same corpus, a disjoint draw stream."""
    corpus = SyntheticCorpus(vocab_size=vocab_size, seed=seed)
    return corpus.sample(generator(seed + 12345), n_samples, seq_len)
