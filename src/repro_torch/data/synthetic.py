"""Synthetic token stream with learnable structure.

The port's copy of the reference package's generator: pure numpy, seeded,
so the same seed yields the same bytes in both packages.  The next-token
distribution is a learnable order-2 Markov chain, so a training loss that
falls below the unigram entropy shows real learning.  Modality stubs
(vision patches, audio frames) are seeded gaussians of the post-frontend
shape.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass
class SyntheticLM:
    vocab: int
    seed: int = 0
    branching: int = 4  # successors per (prev, cur) state

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        # order-2 transition table: (V, B) successor ids + logits
        self.succ = rng.integers(0, self.vocab, size=(self.vocab, self.branching))
        self.probs = rng.dirichlet(np.ones(self.branching), size=self.vocab)

    def sample(self, batch: int, seq: int, rng: np.random.Generator) -> np.ndarray:
        toks = np.empty((batch, seq), dtype=np.int32)
        toks[:, 0] = rng.integers(0, self.vocab, size=batch)
        for t in range(1, seq):
            prev = toks[:, t - 1]
            # one draw per token, in order: a vectorised draw consumes the
            # generator differently and changes every later token
            choice = np.array(
                [rng.choice(self.branching, p=self.probs[p]) for p in prev]
            )
            toks[:, t] = self.succ[prev, choice]
        return toks


def make_batch_iterator(
    cfg: ModelConfig,
    batch: int,
    seq: int,
    *,
    seed: int = 0,
) -> Iterator[Dict[str, np.ndarray]]:
    """Yields model-ready numpy batches for cfg's family, forever."""
    gen = SyntheticLM(cfg.vocab, seed=seed)
    rng = np.random.default_rng(seed + 1)
    while True:
        toks = gen.sample(batch, seq + 1, rng)
        out: Dict[str, np.ndarray] = {
            "tokens": toks[:, :-1],
            "labels": toks[:, 1:],
        }
        if cfg.frontend == "vision":
            out["patches"] = rng.standard_normal(
                (batch, cfg.num_patches, cfg.d_model)
            ).astype(np.float32)
        if cfg.encdec:
            out["frames"] = rng.standard_normal((batch, seq, cfg.d_model)).astype(
                np.float32
            )
        yield out
