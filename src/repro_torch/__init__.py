"""PyTorch/CUDA port of ``repro`` (layered-resolution coded computation).

The package mirrors the JAX package's module names (``core``, ``kernels``,
``runtime``) and never imports JAX: every module it needs is carried here.
Its entry points run on the GPU unless the caller asks for the CPU —
functions on tensors follow the tensor's device, constructors that make
tensors take ``device="cuda"`` by default.  The hand-written kernels
(``kernels/csrc/*.cu``: the layered int8 matmul, flash attention on the
CUDA cores and on the tensor cores, the SSD chunk scan) are compiled for
Hopper (``sm_90a``) at first use; on CPU tensors each kernel wrapper runs
its plain PyTorch version instead.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device: str | torch.device | None = "cuda"
                   ) -> torch.device:
    """A :class:`torch.device`, raising for a CUDA request with no GPU.

    There is no silent CPU fallback: a caller that wants the CPU says
    ``device="cpu"``.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is False; "
            f"pass device='cpu' to run on the host")
    return dev
