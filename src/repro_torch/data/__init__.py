"""Data: the synthetic bigram-chain token stream (``pipeline``)."""

from repro_torch.data import pipeline  # noqa: F401
