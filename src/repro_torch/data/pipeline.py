"""Synthetic deterministic data pipeline (stateless, resumable).

The JAX package's ``data/pipeline.py`` in PyTorch.  Batches are pure
functions of (seed, step): a fixed random bigram chain over the vocab
gives the stream learnable structure (a model that learns the chain drops
from ln(V) to the chain entropy, about ln(branching)).  Stateless indexing
is what makes checkpoint and resume trivial: to resume at step k, ask for
batch k.

The chain's table is the reference's, bit for bit: the same
``np.random.default_rng(seed)`` draw.  The batches are not: the reference
draws each batch's first tokens and successor choices with
``jax.random`` (a key folded with the step), which the port cannot
reproduce without JAX.  The port draws them from a CPU
``torch.Generator`` seeded with ``(seed, step)`` folded through NumPy's
``SeedSequence``, so its batches follow the same chain with other
random choices.  Batches are made on the host and moved to ``device``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import resolve_device

__all__ = ["SyntheticLM", "TokenBatch"]


@dataclasses.dataclass(frozen=True)
class TokenBatch:
    tokens: torch.Tensor      # (B, S) int64
    targets: torch.Tensor     # (B, S) int64 (next-token)


@dataclasses.dataclass(frozen=True)
class SyntheticLM:
    """Bigram-chain token stream.

    branching: number of likely successors per token (entropy ~=
    ln(branching)).  ``device``: where batches are placed, the card unless
    the caller asks for the CPU.
    """

    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    branching: int = 8
    device: str = "cuda"

    def _table(self) -> np.ndarray:
        rng = np.random.default_rng(self.seed)
        return rng.integers(0, self.vocab_size,
                            size=(self.vocab_size, self.branching),
                            dtype=np.int32)

    @property
    def table(self) -> torch.Tensor:
        """The (vocab, branching) successor table, int32 on the host."""
        if not hasattr(self, "_cached"):
            object.__setattr__(self, "_cached",
                               torch.from_numpy(self._table()))
        return self._cached

    def _generator(self, step: int) -> torch.Generator:
        seq = np.random.SeedSequence([self.seed, step])
        return torch.Generator().manual_seed(
            int(seq.generate_state(1, np.uint64)[0] >> np.uint64(1)))

    def batch_at(self, step: int) -> TokenBatch:
        """Deterministic batch for a global step."""
        dev = resolve_device(self.device)
        gen = self._generator(step)
        B, S = self.global_batch, self.seq_len
        first = torch.randint(0, self.vocab_size, (B,), generator=gen)
        choices = torch.randint(0, self.branching, (S, B), generator=gen)
        table = self.table.to(torch.int64)
        full = torch.empty((B, S + 1), dtype=torch.int64)
        full[:, 0] = tok = first
        for t in range(S):
            tok = table[tok, choices[t]]
            full[:, t + 1] = tok
        full = full.to(dev)
        return TokenBatch(tokens=full[:, :-1], targets=full[:, 1:])
