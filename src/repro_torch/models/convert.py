"""Carry parameters (or caches) from NumPy arrays into the port.

The JAX package's parameters are nested dicts and lists of arrays; turned
into NumPy (``jax.tree.map(np.asarray, params)``) they are plain host
data, and :func:`to_torch` makes the port's parameters from them: the
same nesting, as torch tensors on a given device.  This module imports
neither JAX nor the JAX package, so the port stays standalone; the tests
use it to run both packages on the same weights.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device

__all__ = ["to_torch", "array_to_tensor"]


def array_to_tensor(arr, device: torch.device) -> torch.Tensor:
    """One array as a tensor, bit for bit, in memory of its own (the port
    updates caches in place).

    JAX's bf16 arrays come out as ``ml_dtypes.bfloat16``, which
    ``torch.from_numpy`` refuses: they go through a ``uint16`` view of the
    same bits, reinterpreted as ``torch.bfloat16`` (no rounding).
    """
    arr = np.array(arr, copy=True, order="C")    # writable, owned
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device)


def to_torch(tree, device: str | torch.device = "cuda"):
    """A nested structure of dicts, lists and tuples of arrays or tensors
    -> the same structure of tensors on ``device`` (the card unless the
    caller asks for the CPU), each in memory of its own."""
    dev = resolve_device(device)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        if isinstance(node, torch.Tensor):
            return node.to(dev, copy=True)
        return array_to_tensor(node, dev)

    return walk(tree)
