"""Optimizers: AdamW and Adafactor with a cosine schedule and global-norm
clipping (``optimizers``), and the layered gradient all-reduce
(``layered_grads``)."""

from repro_torch.optim import layered_grads, optimizers  # noqa: F401
from repro_torch.optim.optimizers import make_optimizer  # noqa: F401
