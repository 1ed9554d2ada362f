"""G/G/1 delay theory: eqs. (2)-(4) of the paper.

* Service-time lower bound: the whole cluster is at best one super-worker
  whose rate is the sum of the workers' job rates,
  ``E[T_s] >= 1 / sum_p (1 / E[T_p])``.
* Marchal's approximation for the G/G/1 mean waiting time gives the average
  execution delay (arrival -> delivery), eq. (2):
  ``E[D] ~= E[T_s] + E[T_s] * (rho / (1 - rho)) * (c_a^2 + c_s^2) / 2``.
* With layering, the queueing term is unchanged (no early termination) and
  the computational term scales with the fraction of mini-jobs needed for
  resolution l, eq. (3)-(4):
  ``E[T_s^l] >= (sum_{i<=l} J(i) / m^2) * 1 / sum_p (1 / E[T_p])``.

The waiting-time term alone (:func:`gg1_waiting_time`) is the serving
gateway's admission bound: a request's deadline must cover backlog +
expected wait + its resolution's computational share, or the queue
provably cannot serve it in time (see the JAX package's
``runtime/gateway.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.core import layering

__all__ = [
    "Moments", "service_rate_bound", "gg1_waiting_time", "gg1_delay",
    "layered_delay_bounds",
]


@dataclasses.dataclass(frozen=True)
class Moments:
    mean: float
    second_moment: float

    @property
    def variance(self) -> float:
        return max(self.second_moment - self.mean**2, 0.0)

    @property
    def scv(self) -> float:
        """Squared coefficient of variation c^2 = Var / mean^2."""
        return self.variance / self.mean**2 if self.mean > 0 else 0.0


def service_rate_bound(worker_means: Sequence[float]) -> float:
    """Super-worker service rate: sum_p 1/E[T_p] (jobs per unit time)."""
    return float(sum(1.0 / m for m in worker_means))


def gg1_waiting_time(arrival: Moments, service: Moments) -> float:
    """Marchal's G/G/1 mean *waiting* time (the queueing term alone).

    ``W ~= E[T_s] * (rho / (1 - rho)) * (c_a^2 + c_s^2) / 2`` with
    ``rho = E[T_s] / E[T_a]``; ``inf`` when the queue is unstable
    (``rho >= 1``).  Exact for M/D/1, an approximation elsewhere; for
    M/M/1 it reduces to the classic ``Wq = rho / (mu - lambda)``.
    """
    rho = service.mean / arrival.mean
    if rho >= 1.0:
        return float("inf")
    return (service.mean * (rho / (1.0 - rho))
            * (arrival.scv + service.scv) / 2.0)


def gg1_delay(arrival: Moments, service: Moments,
              service_mean_override: float | None = None) -> float:
    """Eq. (2): mean execution delay (compute + queueing), Marchal approx.

    ``service_mean_override`` replaces the *computational* term (first
    summand) — used to inject the theoretical lower bound E[T_s] while the
    queueing term keeps the (empirical or modeled) service moments.
    """
    queue = gg1_waiting_time(arrival, service)
    compute = (service_mean_override
               if service_mean_override is not None else service.mean)
    return compute + queue


def layered_delay_bounds(m: int, worker_means: Sequence[float],
                         arrival: Moments, service: Moments) -> np.ndarray:
    """Eqs. (3)-(4): per-resolution lower bounds on E[D(l)], l = 0..L-1.

    The queueing term uses the supplied service moments (the system's, not
    the layer's: queueing delay is identical across layers for a system
    without termination); the computational term is the layer's share of the
    super-worker bound.
    """
    rate = service_rate_bound(worker_means)
    cum = np.asarray(layering.cumulative_minijobs(m), dtype=np.float64)
    ts_l = (cum / (m * m)) / rate  # eq. (3)
    queue = gg1_waiting_time(arrival, service)
    return ts_l + queue  # eq. (4)
