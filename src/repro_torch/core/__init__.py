"""Core: layered-resolution distributed coded computation (the paper).

Modules:
  layering        digit decomposition + Definition-1 resolution layers
  coding          polynomial coded matmul (float & exact GF(p)) + MDS codes
  scheduling      eq.(1) heterogeneous load balancing
  queueing        eqs.(2)-(4) G/G/1 delay bounds
  simulator       event simulation of the master/workers/fusion system (§IV)
  layered_matmul  executable pipeline + mesh-axis distribution + coded DP
"""

from repro_torch.core import (  # noqa: F401
    coding,
    layered_matmul,
    layering,
    queueing,
    scheduling,
    simulator,
)
