"""Token-mean cross-entropy and top-1 accuracy, in fp32.

The JAX package's ``models/loss.py`` in PyTorch: the logits are taken to
fp32 before the logsumexp, and a mask (B, S) selects the positions that
count (a vlm config's text positions, padding), its denominator clamped
at 1.  The port runs on one device, so the reference's vocab-sharded
reduction is the plain one.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["cross_entropy", "top1_accuracy"]


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  mask: Optional[torch.Tensor] = None):
    """Token-mean CE.  logits (B, S, V) any float dtype; targets (B, S) int.

    Returns (loss, metrics) with fp32 math; metrics are ``loss`` and
    ``ntokens``, the denominator.
    """
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)                      # (B, S)
    true_logit = torch.gather(logits, -1,
                              targets[..., None].to(torch.int64))[..., 0]
    nll = lse - true_logit                                     # (B, S)
    if mask is None:
        denom = torch.tensor(float(nll.numel()), dtype=torch.float32,
                             device=nll.device)
        loss = nll.sum() / denom
    else:
        m = mask.to(torch.float32)
        denom = torch.clamp(m.sum(), min=1.0)
        loss = (nll * m).sum() / denom
    return loss, {"loss": loss, "ntokens": denom}


def top1_accuracy(logits: torch.Tensor, targets: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    hit = (torch.argmax(logits, dim=-1) == targets).to(torch.float32)
    if mask is None:
        return hit.mean()
    m = mask.to(torch.float32)
    return (hit * m).sum() / torch.clamp(m.sum(), min=1.0)
