"""Checkpointing: atomic save and restore of tensor trees (``store``)."""

from repro_torch.checkpoint import store  # noqa: F401
