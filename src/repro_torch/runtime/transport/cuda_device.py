"""The ``cuda`` backend: thread workers whose coded products run on GPUs.

Thread workers (the in-process transport loop is identical to the
``thread`` backend — shared cancel events, zero-copy batches) whose
compute kernel lives on a CUDA device: worker ``p`` pins
``cuda:{p % device_count}`` and runs its coded products as a float64
``torch.matmul`` on its own stream, fed from pinned staging buffers with
asynchronous host-to-device copies, synchronizing only when the product
is copied back for the fusion node.  On a one-card host all workers share
the card and overlap through their streams.

The counterpart of the JAX package's ``jax`` backend.  Construction
raises when no CUDA device is present: the backend never falls back to
host BLAS (``backend="thread"`` is the host backend).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.runtime.tasks import RuntimeConfig, TaskResult
from repro_torch.runtime.transport.thread import ThreadTransport
from repro_torch.runtime.worker import make_compute

__all__ = ["CudaDeviceTransport"]


class CudaDeviceTransport(ThreadTransport):
    """Thread transport with per-worker device-pinned CUDA compute."""

    name = "cuda"

    def __init__(self, cfg: RuntimeConfig,
                 sink: Callable[[TaskResult], None],
                 rng: Optional[np.random.Generator] = None,
                 tracer=None):
        if not torch.cuda.is_available():
            raise RuntimeError(
                "backend='cuda' needs a CUDA device, but "
                "torch.cuda.is_available() is False (backend='thread' runs "
                "the workers on host BLAS)")
        self._devices = [torch.device("cuda", i)
                         for i in range(torch.cuda.device_count())]
        super().__init__(cfg, sink, rng, tracer)

    def _compute_for(self, worker_id: int):
        device = self._devices[worker_id % len(self._devices)]
        return make_compute(self._cfg, worker_id, device=device)
