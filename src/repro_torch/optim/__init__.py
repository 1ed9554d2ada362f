"""Optimizers: AdamW and Adafactor with a cosine schedule and global-norm
clipping (``optimizers``)."""

from repro_torch.optim import optimizers  # noqa: F401
from repro_torch.optim.optimizers import make_optimizer  # noqa: F401
