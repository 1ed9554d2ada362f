"""Online redundancy control: retune ``omega`` between rounds (§IV, ROADMAP).

The paper fixes the redundancy ratio ``omega`` offline, but the whole point
of layering is graceful behavior under *uncertain* straggling.  The measured
runtime already produces exactly the signals an online controller needs —
per-round ``wait`` wall time (worker-side slack, isolated from master
overhead by the pipelined stage accounting), stale-result counts (redundant
work that was actually performed and thrown away), per-worker utilization,
and missed-deadline flags.  :class:`OmegaController` consumes one
:class:`RoundObservation` per dispatched round and retunes ``omega`` — and
with it the code geometry ``T = ceil(k * omega)`` and the eq. (1) task
split ``kappa`` (:func:`repro_torch.core.scheduling.load_split`) — between
rounds.

Geometry economics (why this is cheap): ``omega`` changes the *codeword
length* ``T`` but never the recovery threshold ``k = n1 * n2``, so decode
semantics are untouched.  Each distinct ``T`` has its own
:class:`~repro_torch.core.coding.DecodePlan` (one Vandermonde build, then an LRU
of per-arrival-set solve operators) held in a process-wide per-geometry
cache, so switching *back* to a previously-used geometry is free; the first
switch to a fresh geometry pays one plan construction — measured here and
reported per switch in the controller trace (``prime_seconds``) — and the
first fuse under it pays one solve-operator factorization inside the plan's
LRU.

Policies (pluggable via :data:`POLICIES` or any :class:`OmegaPolicy`):

``fixed``
    Never moves.  The default; makes an adaptive run degrade to the static
    paper system, and gives the benchmarks their static baselines.
``aimd``
    TCP-style additive-increase / multiplicative-decrease.  Grow ``omega``
    additively when a round misses its deadline, when the EWMA of round
    waits projects the job past ``t_term``, or when one round's wait
    spikes far above the EWMA (the deadline-*free* grow signal — without
    it a deadline-less run could only ever shrink); shrink multiplicatively
    when stale results pile up (redundant tasks that finished compute
    after fusion — pure waste).
``deadline-margin``
    Band controller on the *margin ratio* — remaining time to ``t_term``
    over projected remaining round time.  Grow when the ratio drops below
    the band (or on a realized miss / wait spike), shrink (additively)
    when the ratio sits comfortably above the band while stale results
    accumulate.  More conservative than ``aimd``: it acts on the
    predicted miss, not only the realized one.

All times are seconds (``time.monotonic`` deltas).  The controller is
master-thread-only (no locking): :meth:`OmegaController.observe` is called
from :meth:`repro_torch.runtime.master.Master.run` between rounds, never
concurrently.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence, Union

import numpy as np

__all__ = ["RoundObservation", "OmegaPolicy", "FixedPolicy", "AIMDPolicy",
           "DeadlineMarginPolicy", "OmegaController", "POLICIES",
           "make_policy", "margin_ratio"]


def margin_ratio(margin: Optional[float], unit_ewma: Optional[float],
                 units_left: int) -> Optional[float]:
    """The §IV deadline-margin ratio, shared across consumers.

    ``margin`` seconds remain before the deadline; ``units_left`` units of
    work (mini-job rounds for the runtime, head planes for serving) are
    still to run, each projected to take ``unit_ewma`` seconds.  The ratio
    is *how many projected remainders fit in the time left* — < 1 means a
    predicted miss.  Returns None when undefined (no deadline, no work
    left, or no cost estimate yet); callers treat None as "no signal".

    :class:`DeadlineMarginPolicy` (retuning ω between rounds) leans on
    this function.  (The serving path's historical plane-budget adapter
    did too; since ``launch/serve.py`` routes deadlines through the
    runtime itself, the runtime's §IV machinery is the only deadline
    controller left.)
    """
    if (margin is None or units_left <= 0 or unit_ewma is None
            or unit_ewma <= 0.0):
        return None
    return margin / (unit_ewma * units_left)


@dataclasses.dataclass(frozen=True)
class RoundObservation:
    """What the master saw for one dispatched round (all times seconds).

    ``wait``
        Seconds the master blocked on fusion for this round — the worker-
        side slack signal (``RuntimeResult.stage_seconds['wait']``'s
        per-round term), free of master-side encode/decode overhead.
    ``fused``
        False when the round timed out at ``t_term`` (the §IV missed-
        deadline flag: the job was terminated with this round unfused).
    ``stale``
        Task results that arrived after a round fused (counted since the
        previous observation): redundant work that was actually *performed*
        and dropped — the over-provisioning signal.
    ``deadline_margin``
        ``t_term - now`` right after the round resolved (None when the job
        has no termination time, i.e. no deadline or no queued successor).
    ``rounds_left``
        Mini-job rounds still to run for this job after this round.
    ``utilization``
        Per-worker busy fraction since the run started (delay + compute
        over wall time), from the pool's occupancy counters.  The
        built-in policies key on wait/stale/margin only; this field is
        part of the observation contract for *custom* policies (e.g.
        per-worker blacklisting or load-aware splits).
    """

    round_idx: int
    job_id: int
    wait: float
    fused: bool
    stale: int
    deadline_margin: Optional[float]
    rounds_left: int
    utilization: Optional[np.ndarray] = None


class OmegaPolicy:
    """One retuning rule: maps an observation to a new (unclipped) omega.

    Stateful (EWMAs live on the instance); instances are single-run,
    master-thread-only.  :meth:`step` returns ``(new_omega, reason)`` with
    ``reason`` a short human-readable string when the policy moved, else
    ``None`` (``new_omega == omega``).  Bounds are enforced by the
    controller, not the policy.
    """

    def step(self, obs: RoundObservation,
             omega: float) -> tuple[float, Optional[str]]:
        raise NotImplementedError

    def _ewma(self, prev: Optional[float], x: float, alpha: float) -> float:
        return x if prev is None else (1.0 - alpha) * prev + alpha * x


class FixedPolicy(OmegaPolicy):
    """The static paper system: omega never moves."""

    name = "fixed"

    def step(self, obs, omega):
        return omega, None


class _EwmaPolicy(OmegaPolicy):
    """Shared scaffolding for the built-in adaptive policies.

    Maintains the stale-per-round and round-wait EWMAs, and implements the
    signals both policies agree on:

    * a realized §IV miss (``obs.fused`` False) always grows;
    * a **wait spike** — one round's wait exceeding ``spike_factor`` times
      the wait EWMA — always grows.  This is the deadline-*free* grow
      signal: without it, a run with no configured deadline has no miss
      signal at all and stale-driven shrinks would ratchet omega one-way
      to ``omega_min`` (T = k), exactly the brittle geometry an outage
      punishes;
    * stale pile-up (EWMA above ``stale_tolerance``) shrinks, gated by the
      subclass (``_may_shrink``), and the EWMA resets after acting so one
      burst is acted on once.

    Subclasses provide the policy-specific grow trigger (``_grow_reason``,
    called with the pre-spike-update EWMA) and shrink arithmetic
    (``_shrink``).
    """

    def __init__(self, *, grow_step: float, stale_tolerance: float,
                 alpha: float, spike_factor: float):
        if spike_factor <= 1.0:
            raise ValueError(
                f"spike_factor must be > 1, got {spike_factor}")
        self.grow_step = grow_step
        self.stale_tolerance = stale_tolerance
        self.alpha = alpha
        self.spike_factor = spike_factor
        self._wait_ewma: Optional[float] = None
        self._stale_ewma = 0.0

    def step(self, obs, omega):
        self._stale_ewma = self._ewma(self._stale_ewma, float(obs.stale),
                                      self.alpha)
        if not obs.fused:
            return omega + self.grow_step, "missed deadline"
        prev_wait = self._wait_ewma
        self._wait_ewma = self._ewma(prev_wait, obs.wait, self.alpha)
        if (prev_wait is not None and prev_wait > 0.0
                and obs.wait > self.spike_factor * prev_wait):
            return omega + self.grow_step, (
                f"wait spike ({obs.wait * 1e3:.1f} ms > "
                f"{self.spike_factor:g}x ewma)")
        reason = self._grow_reason(obs)
        if reason is not None:
            return omega + self.grow_step, reason
        if self._stale_ewma > self.stale_tolerance and self._may_shrink(obs):
            self._stale_ewma = 0.0   # acted on the signal; re-accumulate
            return self._shrink(omega), "stale results piling up"
        return omega, None

    def _grow_reason(self, obs) -> Optional[str]:
        """Policy-specific grow trigger (EWMAs already updated)."""
        return None

    def _may_shrink(self, obs) -> bool:
        return True

    def _shrink(self, omega: float) -> float:
        raise NotImplementedError


class AIMDPolicy(_EwmaPolicy):
    """Additive increase on miss signals, multiplicative decrease on
    stale pile-up.

    ``increase``        additive omega step on a grow signal.
    ``decrease``        multiplicative factor (< 1) on a waste signal.
    ``stale_tolerance`` EWMA stale-results-per-round above which redundancy
                        is considered wasteful.
    ``headroom``        projected-miss guard: grow when
                        ``rounds_left * wait_ewma * headroom`` exceeds the
                        remaining deadline margin.
    ``spike_factor``    deadline-free guard: grow when one round's wait
                        exceeds this multiple of the wait EWMA.
    """

    name = "aimd"

    def __init__(self, *, increase: float = 0.25, decrease: float = 0.85,
                 stale_tolerance: float = 1.0, headroom: float = 1.0,
                 alpha: float = 0.3, spike_factor: float = 4.0):
        if not 0.0 < decrease < 1.0:
            raise ValueError(f"decrease must be in (0, 1), got {decrease}")
        super().__init__(grow_step=increase, stale_tolerance=stale_tolerance,
                         alpha=alpha, spike_factor=spike_factor)
        self.decrease = decrease
        self.headroom = headroom

    def _grow_reason(self, obs):
        if (obs.deadline_margin is not None and obs.rounds_left > 0
                and self._wait_ewma is not None
                and obs.rounds_left * self._wait_ewma * self.headroom
                > obs.deadline_margin):
            return "projected deadline miss"
        return None

    def _shrink(self, omega):
        return omega * self.decrease


class DeadlineMarginPolicy(_EwmaPolicy):
    """Band control on the deadline margin ratio.

    The margin ratio is ``deadline_margin / (wait_ewma * rounds_left)`` —
    how many projected-remaining-job-times fit in the time left before
    ``t_term``.  Below ``low`` the job is threatened: grow omega by
    ``step_up``.  Above ``high`` with stale results accumulating, the
    redundancy is buying nothing: shrink by ``step_down``.  A realized
    miss or a wait spike (the deadline-free signal) always grows.
    """

    name = "deadline-margin"

    def __init__(self, *, low: float = 1.5, high: float = 6.0,
                 step_up: float = 0.25, step_down: float = 0.125,
                 stale_tolerance: float = 1.0, alpha: float = 0.3,
                 spike_factor: float = 4.0):
        if low >= high:
            raise ValueError(f"need low < high, got {low} >= {high}")
        super().__init__(grow_step=step_up, stale_tolerance=stale_tolerance,
                         alpha=alpha, spike_factor=spike_factor)
        self.low = low
        self.high = high
        self.step_down = step_down
        self._last_ratio: Optional[float] = None

    def _margin_ratio(self, obs) -> Optional[float]:
        return margin_ratio(obs.deadline_margin, self._wait_ewma or None,
                            obs.rounds_left)

    def _grow_reason(self, obs):
        self._last_ratio = ratio = self._margin_ratio(obs)
        if ratio is not None and ratio < self.low:
            return f"margin ratio {ratio:.2f} < {self.low}"
        return None

    def _may_shrink(self, obs):
        # never trim while the margin is anywhere near the grow band
        return self._last_ratio is None or self._last_ratio > self.high

    def _shrink(self, omega):
        return omega - self.step_down


POLICIES: dict[str, type[OmegaPolicy]] = {
    FixedPolicy.name: FixedPolicy,
    AIMDPolicy.name: AIMDPolicy,
    DeadlineMarginPolicy.name: DeadlineMarginPolicy,
}


def make_policy(policy: Union[str, OmegaPolicy, None]) -> OmegaPolicy:
    """Resolve a policy name (see :data:`POLICIES`) or pass an instance."""
    if policy is None:
        return FixedPolicy()
    if isinstance(policy, OmegaPolicy):
        return policy
    try:
        return POLICIES[policy]()
    except KeyError:
        raise ValueError(f"unknown omega policy {policy!r}; "
                         f"known: {sorted(POLICIES)}") from None


class OmegaController:
    """Owns the runtime's *current* code geometry and retunes it online.

    The master asks the controller for the current ``(code, kappa)`` pair
    when encoding a round, and feeds back one :class:`RoundObservation`
    after each round resolves.  When the policy's (clipped) omega crosses a
    codeword-length boundary (``T = max(k, ceil(k * omega))`` changes), the
    controller *switches geometry*: it builds the new
    :class:`~repro_torch.core.coding.PolynomialCode`, primes its per-geometry
    :class:`~repro_torch.core.coding.DecodePlan` (timed — ``prime_seconds`` in
    the trace; ~0 when returning to a previously-seen geometry, one
    Vandermonde build otherwise), and recomputes the eq. (1) split for the
    new ``T``.  Omega moves *within* a codeword-length bucket are traced
    but switch nothing.

    Master-thread-only (called between rounds, never concurrently); the
    per-geometry plan caches it leans on are themselves thread-safe.
    """

    def __init__(self, cfg, policy: Union[str, OmegaPolicy, None] = None):
        self.cfg = cfg
        self.policy = make_policy(policy if policy is not None
                                  else getattr(cfg, "adapt", "fixed"))
        self.omega_min = float(getattr(cfg, "omega_min", 1.0))
        self.omega_max = float(getattr(cfg, "omega_max", 3.0))
        # Bounds constrain the *adaptive* policies only: a fixed-policy
        # controller must reproduce the configured static geometry
        # verbatim (simulator agreement depends on it), even when
        # cfg.omega sits outside the (inert) adaptive bounds.
        if isinstance(self.policy, FixedPolicy):
            self.omega = float(cfg.omega)
        else:
            self.omega = float(np.clip(cfg.omega, self.omega_min,
                                       self.omega_max))
        self.omega_initial = self.omega
        self.code = cfg.code(omega=self.omega)
        self.kappa = cfg.load_split(total=self.code.num_tasks)
        self.trace: list[dict] = []
        self.switches = 0
        self.prime_seconds_total = 0.0
        # fault-supervision state: the surviving fleet the eq. (1) split
        # runs over (None = everyone), and the omega the fleet forced us
        # down from (restored when readmissions regrow the fleet)
        self.active: Optional[tuple[int, ...]] = None
        self._omega_pre_shrink: Optional[float] = None

    @property
    def total_tasks(self) -> int:
        """Current codeword length ``T``."""
        return self.code.num_tasks

    def observe(self, obs: RoundObservation) -> bool:
        """Feed one round's observation; returns True on a geometry switch.

        A switch means subsequently-encoded rounds use a different codeword
        length (the already-encoded in-flight/buffered round keeps the
        geometry it was encoded with — the master carries ``kappa``
        alongside each encoded buffer).
        """
        new_omega, reason = self.policy.step(obs, self.omega)
        new_omega = float(np.clip(new_omega, self.omega_min, self.omega_max))
        if new_omega == self.omega:
            return False
        old_omega, old_T = self.omega, self.code.num_tasks
        # the codeword-length rule lives in ONE place (PolynomialCode):
        # derive T from the candidate code rather than re-deriving the
        # ceil formula here
        new_code = self.cfg.code(omega=new_omega)
        new_T = new_code.num_tasks
        self.omega = new_omega
        prime = 0.0
        switched = new_T != old_T
        if switched:
            t0 = time.perf_counter()
            self.code = new_code
            self.code.plan()    # per-geometry DecodePlan: built or reused
            prime = time.perf_counter() - t0
            self.kappa = self.cfg.load_split(total=new_T,
                                             active=self.active)
            self.switches += 1
            self.prime_seconds_total += prime
        self.trace.append({
            "round": obs.round_idx, "job": obs.job_id,
            "omega_old": round(old_omega, 4), "omega_new": round(new_omega, 4),
            "T_old": old_T, "T_new": new_T, "switched": switched,
            "kappa": [int(x) for x in self.kappa],
            "reason": reason, "prime_seconds": prime,
        })
        return switched

    def refit_fleet(self, active: Sequence[int]) -> bool:
        """Re-split the eq. (1) kappa over a changed surviving fleet.

        The fault supervisor calls this after a quarantine (fleet shrank)
        or a readmission (fleet grew).  Returns False — and changes
        nothing — when the surviving fleet fell below the recovery
        threshold (``len(active) < k``, the fleet-collapse line):
        the caller must then release at a degraded resolution.

        Geometry rule — shrink proportionally, "if omega allows": the
        codeword length ``T = ceil(k * omega)`` was provisioned for the
        FULL fleet's service capacity, so when survivors carry only a
        fraction of ``sum(mu)`` the effective redundancy is scaled by
        that same fraction, floored at ``omega = 1`` (``T = k``, the
        structural minimum — past that there is nothing left to shrink).
        ``kappa`` is always re-split over the survivors alone (workers
        legitimately hold multi-task slices — ``T`` may exceed the
        worker count even at full fleet).  The un-scaled omega is
        remembered so a readmission that restores capacity restores the
        geometry with it; a policy retune while shrunk rebases the
        remembered value the next time the fleet changes.  All moves are
        traced like policy retunes (``reason`` prefixed ``fleet``).
        """
        k = self.cfg.k
        active = tuple(sorted(set(active)))
        S = len(active)
        if S < k:
            return False
        full = S >= self.cfg.num_workers
        self.active = None if full else active
        base = (self.omega if self._omega_pre_shrink is None
                else self._omega_pre_shrink)
        mu = np.asarray(self.cfg.mu, dtype=np.float64)
        scale = float(mu[list(active)].sum() / mu.sum())
        new_omega = max(1.0, base * scale)
        self._omega_pre_shrink = None if full else base
        old_omega, old_T = self.omega, self.code.num_tasks
        new_code = self.cfg.code(omega=new_omega)
        new_T = new_code.num_tasks
        self.omega = new_omega
        prime = 0.0
        switched = new_T != old_T
        if switched:
            t0 = time.perf_counter()
            self.code = new_code
            self.code.plan()
            prime = time.perf_counter() - t0
            self.switches += 1
            self.prime_seconds_total += prime
        self.kappa = self.cfg.load_split(total=new_T, active=self.active)
        self.trace.append({
            "round": -1, "job": -1,
            "omega_old": round(old_omega, 4),
            "omega_new": round(new_omega, 4),
            "T_old": old_T, "T_new": new_T, "switched": switched,
            "kappa": [int(x) for x in self.kappa],
            "reason": f"fleet refit: {S}/{self.cfg.num_workers} workers "
                      f"active",
            "prime_seconds": prime,
        })
        return True

    def summary(self) -> dict:
        """JSON-serializable controller outcome (RuntimeResult.controller)."""
        return {
            "policy": getattr(self.policy, "name",
                              type(self.policy).__name__),
            "omega_initial": self.omega_initial,
            "omega_final": self.omega,
            "omega_bounds": [self.omega_min, self.omega_max],
            "T_final": self.total_tasks,
            "retunes": len(self.trace),
            "switches": self.switches,
            "prime_seconds_total": self.prime_seconds_total,
        }
