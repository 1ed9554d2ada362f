"""Joint coding-scheduling load balancing for heterogeneous workers.

Implements eq. (1) of the paper (from Esfahanizadeh et al., INFOCOM'22):
given the first two moments of each worker's per-job response time, the
number of coded tasks assigned to worker p is

    kappa_p = b_p / (2 gamma m_p^2) * (-1 + sqrt(1 + 4 gamma m_p^2 theta / b_p^2))

with ``m_p = E[T_p]``, ``sigma_p^2 = Var[T_p]``, ``b_p = m_p + gamma sigma_p^2``
and ``theta > 0`` chosen so that ``sum_p kappa_p = k * omega``.  The real
solution is then rounded to integers preserving the sum (largest-remainder).

The closed form equalises the (mean + gamma * variance)-penalised completion
time distributions across workers, which minimises the time until the fusion
node holds ``k`` task results.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

__all__ = ["WorkerStats", "load_split", "worker_job_moments"]


@dataclasses.dataclass(frozen=True)
class WorkerStats:
    """First/second moments of one worker's per-job computation time."""

    mean: float          # m_p = E[T_p]
    second_moment: float  # E[T_p^2]

    @property
    def variance(self) -> float:
        return max(self.second_moment - self.mean**2, 0.0)


def worker_job_moments(mu: float, k: int, c: float) -> WorkerStats:
    """Moments of a worker's time to do one whole job alone.

    A job is ``k`` tasks of complexity ``c``; each task time is
    Exp(rate = mu / c), so the job time is Gamma(k, mu/c):
    mean = k c / mu, var = k c^2 / mu^2.
    """
    mean = k * c / mu
    var = k * (c / mu) ** 2
    return WorkerStats(mean=mean, second_moment=var + mean**2)


def _kappa_real(stats: Sequence[WorkerStats], theta: float,
                gamma: float) -> np.ndarray:
    m = np.array([s.mean for s in stats], dtype=np.float64)
    var = np.array([s.variance for s in stats], dtype=np.float64)
    b = m + gamma * var
    return b / (2 * gamma * m**2) * (
        -1.0 + np.sqrt(1.0 + 4.0 * gamma * m**2 * theta / b**2))


def load_split(stats: Sequence[WorkerStats], total_tasks: int,
               gamma: float = 1.0) -> np.ndarray:
    """Integer task counts kappa_p (sum == total_tasks) per eq. (1).

    theta is found by bisection: kappa is monotone increasing in theta.
    """
    if total_tasks < 0:
        raise ValueError("total_tasks must be >= 0")
    if not stats:
        raise ValueError("need at least one worker")
    if total_tasks == 0:
        return np.zeros(len(stats), dtype=np.int64)

    lo, hi = 1e-12, 1.0
    while _kappa_real(stats, hi, gamma).sum() < total_tasks:
        hi *= 2.0
        if hi > 1e18:
            raise RuntimeError("theta bisection failed to bracket")
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if _kappa_real(stats, mid, gamma).sum() < total_tasks:
            lo = mid
        else:
            hi = mid
    kappa = _kappa_real(stats, 0.5 * (lo + hi), gamma)

    # Largest-remainder rounding, preserving the exact sum.
    floor = np.floor(kappa).astype(np.int64)
    short = int(total_tasks - floor.sum())
    if short > 0:
        order = np.argsort(-(kappa - floor))
        floor[order[:short]] += 1
    elif short < 0:  # numerically possible after bisection
        order = np.argsort(kappa - floor)
        take = 0
        for idx in order:
            if take == -short:
                break
            if floor[idx] > 0:
                floor[idx] -= 1
                take += 1
    assert floor.sum() == total_tasks, (floor.sum(), total_tasks)
    return floor
