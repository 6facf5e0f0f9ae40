"""Deterministic synthetic LM data (an offline stand-in for a corpus), the
torch counterpart of the JAX package's ``data/pipeline.py``.

Counter-based: batch ``i`` is a pure function of ``(seed, i)``, drawn from a
``torch.Generator`` seeded from both, so the pipeline's state is the step
counter the trainer already checkpoints.  Tokens are Zipf unigrams with a
light Markov structure (with probability 0.3 a token repeats the previous
draw plus one), so losses behave like text rather than uniform noise.
Torch cannot give JAX's threefry numbers: the same distributions, not the
same draws.  The draws are made on the CPU, so a batch is the same whatever
device trains on it.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

Tensor = torch.Tensor

REPEAT_P = 0.3  # chance that a token is the previous draw plus one


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    batch: int
    seq_len: int
    seed: int = 0
    zipf_a: float = 1.2


def _generator(*words: int) -> torch.Generator:
    """A CPU generator seeded from ``words`` (mixed by numpy's SeedSequence)."""
    seed = int(np.random.SeedSequence([w & 0xFFFFFFFF for w in words]).generate_state(2, np.uint64)[0])
    return torch.Generator().manual_seed(seed)


class SyntheticTokens:
    """``batch(i)`` gives the same tokens for the same ``(seed, i)``, in any order."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        ranks = np.arange(1, cfg.vocab + 1, dtype=np.float64)
        probs = ranks ** (-cfg.zipf_a)
        self.probs = torch.from_numpy(probs / probs.sum())  # the Zipf unigram law, float64

    def _draws(self, index: int) -> tuple[Tensor, Tensor]:
        """The unigram draws (B, L+1) int64 and the repeat flags (B, L+1) bool."""
        cfg = self.cfg
        gen = _generator(cfg.seed, index)
        n = cfg.batch * (cfg.seq_len + 1)
        base = torch.multinomial(self.probs, n, replacement=True, generator=gen)
        rep = torch.rand(n, generator=gen, dtype=torch.float64) < REPEAT_P
        shape = (cfg.batch, cfg.seq_len + 1)
        return base.reshape(shape), rep.reshape(shape)

    def batch(self, index: int) -> dict[str, Tensor]:
        """``{"tokens", "labels"}``, each (B, L) int32 on the CPU: the two
        shifted views of one (B, L+1) stream."""
        base, rep = self._draws(index)
        shifted = torch.roll(base, 1, dims=1) + 1
        stream = torch.where(rep, shifted % self.cfg.vocab, base).to(torch.int32)
        return {"tokens": stream[:, :-1], "labels": stream[:, 1:]}

    def frames(self, index: int, enc_seq: int, d_model: int) -> Tensor:
        """Stub audio/image frontend features (B, enc_seq, d_model) fp32 for
        encoder-decoder archs."""
        gen = _generator(self.cfg.seed ^ 0xF00D, index)
        return torch.randn((self.cfg.batch, enc_seq, d_model), generator=gen)
