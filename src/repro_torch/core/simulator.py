"""Event simulation of the layered distributed coded computing system (§IV).

Reproduces the paper's evaluation: a master node with a FIFO queue of jobs
(Poisson arrivals), P heterogeneous workers (task time ~ Exp(mu_p / c) for a
task of complexity c), and a fusion node that needs any ``k`` of the
``k * omega`` coded task results per matrix-matrix multiplication.

Layered mode decomposes each job into ``m**2`` mini-jobs of complexity
``c / m**2`` each, executed round-by-round in MSB-first resolution order;
round r ends when the fusion holds k results for that mini-job, at which
point the master *purges* the round's outstanding tasks (workers are
immediately free — captured by sampling rounds independently).

Deadline semantics (paper §IV): a running job is terminated at
``t_term = max(service_start + deadline, next_job_arrival)`` if it has not
finished by then — i.e. termination requires BOTH the compute time to exceed
the deadline AND a queued successor.  The fusion then releases the highest
resolution whose rounds completed before ``t_term``.

All task-duration sampling is vectorised; only the O(num_jobs) queue
recursion is a Python loop.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.core import layering, queueing, scheduling

__all__ = ["SystemConfig", "SimResult", "simulate", "PAPER_SYSTEM"]


@dataclasses.dataclass(frozen=True)
class SystemConfig:
    """Cluster + workload parameters (defaults = the paper's §IV setup)."""

    mu: tuple[float, ...] = (385.95, 650.92, 373.40, 415.75, 373.98)
    arrival_rate: float = 0.01        # Poisson job arrivals, lambda
    k: int = 1000                     # critical tasks per matmul
    complexity: float = 50.0          # per-task complexity, no layering
    m: int = 2                        # digit chunks -> L = 2m-1 layers
    omega: float = 1.06               # redundancy ratio
    gamma: float = 1.0                # eq. (1) moment trade-off

    @property
    def num_workers(self) -> int:
        return len(self.mu)

    @property
    def num_layers(self) -> int:
        return layering.num_layers(self.m)

    @property
    def minijob_complexity(self) -> float:
        # Each mini-job multiplies chunk matrices: 1/m**2 of the full work.
        return self.complexity / (self.m * self.m)

    @property
    def total_tasks(self) -> int:
        import math
        return math.ceil(self.k * self.omega)


PAPER_SYSTEM = SystemConfig()


@dataclasses.dataclass
class SimResult:
    """Per-job outcome arrays.

    ``layer_compute[j, l]`` is the compute time (from service start) at which
    resolution l of job j completed; for no-layering runs L == 1.
    ``delay[j, l] = service_start + layer_compute - arrival`` (inf if that
    resolution was cut off by termination).
    """

    arrivals: np.ndarray        # (J,)
    starts: np.ndarray          # (J,)
    ends: np.ndarray            # (J,)  service end (finish or termination)
    layer_compute: np.ndarray   # (J, L)
    success: np.ndarray         # (J, L) bool
    terminated: np.ndarray      # (J,)  bool
    kappa: np.ndarray           # (P,)  eq.(1) load split used

    @property
    def delay(self) -> np.ndarray:
        d = self.starts[:, None] + self.layer_compute - self.arrivals[:, None]
        return np.where(self.success, d, np.inf)

    @property
    def num_jobs(self) -> int:
        return len(self.arrivals)

    def mean_delay(self) -> np.ndarray:
        """Mean execution delay per resolution over successful jobs."""
        d = self.delay
        out = np.empty(d.shape[1])
        for l in range(d.shape[1]):
            ok = np.isfinite(d[:, l])
            out[l] = d[ok, l].mean() if ok.any() else np.inf
        return out

    def success_rate(self) -> np.ndarray:
        return self.success.mean(axis=0)

    def service_moments(self) -> queueing.Moments:
        """Empirical moments of the full (untruncated) service time."""
        ts = self.layer_compute[:, -1]
        return queueing.Moments(mean=float(ts.mean()),
                                second_moment=float((ts**2).mean()))


def _round_durations(rng: np.random.Generator, cfg: SystemConfig,
                     kappa: np.ndarray, num_jobs: int, rounds: int,
                     complexity: float, batch: int = 2048) -> np.ndarray:
    """(num_jobs, rounds) time for the fusion to collect k results per round.

    Worker p runs its kappa_p tasks sequentially (completion offsets are a
    cumulative sum of Exp(c / mu_p) draws); the round ends at the k-th
    smallest completion offset across all workers.  Workers whose queue is
    purged simply idle until the round boundary, matching the paper's
    master-paced, one-mini-job-at-a-time schedule.
    """
    k = cfg.k
    out = np.empty((num_jobs, rounds), dtype=np.float64)
    for lo in range(0, num_jobs, batch):
        hi = min(lo + batch, num_jobs)
        n = hi - lo
        streams = []
        for p, kp in enumerate(kappa):
            if kp == 0:
                continue
            scale = complexity / cfg.mu[p]
            t = rng.exponential(scale=scale, size=(n, rounds, int(kp)))
            streams.append(np.cumsum(t, axis=-1))
        merged = np.concatenate(streams, axis=-1)
        if merged.shape[-1] < k:
            raise ValueError(
                f"only {merged.shape[-1]} tasks assigned but k={k} needed")
        out[lo:hi] = np.partition(merged, k - 1, axis=-1)[..., k - 1]
    return out


def simulate(cfg: SystemConfig, num_jobs: int, *, layered: bool = True,
             deadline: float | None = None, seed: int = 0) -> SimResult:
    """Run the queueing simulation for ``num_jobs`` jobs."""
    rng = np.random.default_rng(seed)
    arrivals = np.cumsum(rng.exponential(1.0 / cfg.arrival_rate,
                                         size=num_jobs))

    if layered:
        rounds = cfg.m * cfg.m
        complexity = cfg.minijob_complexity
        cum = np.asarray(layering.cumulative_minijobs(cfg.m))  # (L,)
    else:
        rounds = 1
        complexity = cfg.complexity
        cum = np.asarray([1])

    stats = [scheduling.worker_job_moments(mu, cfg.k, complexity)
             for mu in cfg.mu]
    kappa = scheduling.load_split(stats, cfg.total_tasks, cfg.gamma)

    durs = _round_durations(rng, cfg, kappa, num_jobs, rounds, complexity)
    round_ends = np.cumsum(durs, axis=1)            # (J, rounds)
    layer_compute = round_ends[:, cum - 1]          # (J, L)
    total_compute = round_ends[:, -1]               # (J,)

    starts = np.empty(num_jobs)
    ends = np.empty(num_jobs)
    terminated = np.zeros(num_jobs, dtype=bool)
    prev_end = 0.0
    for j in range(num_jobs):
        start = max(arrivals[j], prev_end)
        finish = start + total_compute[j]
        if deadline is not None and j + 1 < num_jobs:
            t_term = max(start + deadline, arrivals[j + 1])
            if finish > t_term:
                finish = t_term
                terminated[j] = True
        starts[j] = start
        ends[j] = finish
        prev_end = finish

    success = starts[:, None] + layer_compute <= ends[:, None] + 1e-12
    return SimResult(arrivals=arrivals, starts=starts, ends=ends,
                     layer_compute=layer_compute, success=success,
                     terminated=terminated, kappa=kappa)


def theory_bounds(cfg: SystemConfig, service: queueing.Moments,
                  layered: bool = True) -> np.ndarray:
    """Paper eqs. (2)-(4) lower bounds matching :func:`simulate`'s output.

    The queueing term uses the supplied (empirical) service moments; the
    computational term is the super-worker bound, per layer if layered.
    """
    # E[T_p] for one full job = k tasks of complexity c (Gamma mean).
    worker_means = [cfg.k * cfg.complexity / mu for mu in cfg.mu]
    arrival = queueing.Moments(mean=1.0 / cfg.arrival_rate,
                               second_moment=2.0 / cfg.arrival_rate**2)
    if layered:
        return queueing.layered_delay_bounds(cfg.m, worker_means, arrival,
                                             service)
    bound = 1.0 / queueing.service_rate_bound(worker_means)
    return np.asarray([queueing.gg1_delay(arrival, service,
                                          service_mean_override=bound)])
