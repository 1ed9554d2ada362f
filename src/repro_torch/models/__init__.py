"""Models: layers, the Mamba2 SSM block, the RG-LRU block, the MoE block,
transformer assembly, and ``convert`` (NumPy parameter trees into the
port)."""

from repro_torch.models import (  # noqa: F401
    convert,
    layers,
    moe,
    rglru,
    ssm,
    transformer,
)
