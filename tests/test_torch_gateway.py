"""Port parity: the serving gateway (``repro_torch.runtime.gateway``).

The cases of the JAX package's ``tests/test_gateway.py``, on the port and
its ``thread`` runtime backend: G/G/1 admission bounds against
hand-computed numbers, the request lifecycle over a live fleet, shutdown
hygiene, and the property block over seeded arrival schedules.  The
deterministic tier isolates :meth:`AdmissionController.decide` (a pure
function of the moments) so every admit / down-resolve / reject verdict
is checked against arithmetic done by hand in the comments; one more case
holds the port's verdicts equal to the JAX package's.
"""

import threading
import time

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from _hypothesis_compat import hypothesis, st  # noqa: E402
from repro_torch.core.layering import cumulative_minijobs  # noqa: E402
from repro_torch.core.queueing import Moments, gg1_waiting_time  # noqa
from repro_torch.runtime import RuntimeConfig, ServingGateway  # noqa: E402
from repro_torch.runtime.gateway import (  # noqa: E402
    MIN_SAMPLES, AdmissionController)

MU3 = (385.95, 650.92, 373.40)

# hand-computed fixture: m=2 (cum = [1, 3, 4]), exponential-like moments
#   arrival  E[A]=0.1,  E[A^2]=0.02   -> c_a^2 = 1
#   service  E[S]=0.04, E[S^2]=0.0032 -> c_s^2 = 1, rho = 0.4
#   W = E[S] * rho/(1-rho) * (c_a^2+c_s^2)/2 = 0.04 * (2/3) = 0.0266667
#   est(l) = W + 0.04 * cum[l]/4:
#     est(2) = 0.0666667   est(1) = 0.0566667   est(0) = 0.0366667
ARRIVAL = Moments(0.1, 0.02)
SERVICE = Moments(0.04, 0.0032)
W = 0.04 * (0.4 / 0.6)


def _cfg(**kw):
    defaults = dict(mu=MU3, arrival_rate=50.0, n1=2, n2=2, omega=1.5,
                    m=2, d=8, complexity=10.0, straggler="none",
                    backend="thread", seed=0)
    defaults.update(kw)
    return RuntimeConfig(**defaults)


def _operands(rng, cfg, k=16, n=4):
    lim = 1 << (cfg.m * cfg.d - 2)
    a = rng.integers(-lim, lim, size=(k, cfg.n1 * n), dtype=np.int64)
    b = rng.integers(-lim, lim, size=(k, cfg.n2 * n), dtype=np.int64)
    return a, b


class TestAdmissionBound:
    """decide() against the hand-computed G/G/1 numbers above."""

    def test_waiting_time_matches_hand_computation(self):
        assert gg1_waiting_time(ARRIVAL, SERVICE) == pytest.approx(W)

    def test_admits_full_resolution_when_deadline_covers_it(self):
        dec, res, est = AdmissionController.decide(
            0.07, 2, 0, 0.0, ARRIVAL, SERVICE, m=2, safety=1.0)
        assert (dec, res) == ("admitted", 2)
        assert est == pytest.approx(W + 0.04)

    def test_down_resolves_to_largest_fitting_resolution(self):
        # 0.06 < est(2)=0.0667 but >= est(1)=0.0567
        dec, res, est = AdmissionController.decide(
            0.06, 2, 0, 0.0, ARRIVAL, SERVICE, m=2, safety=1.0)
        assert (dec, res) == ("down-resolved", 1)
        assert est == pytest.approx(W + 0.03)

    def test_rejects_below_the_floor_estimate(self):
        # 0.03 < est(0)=0.0367: nothing fits; estimate reported is the
        # floor resolution's (what the client would have needed)
        dec, res, est = AdmissionController.decide(
            0.03, 2, 0, 0.0, ARRIVAL, SERVICE, m=2, safety=1.0)
        assert (dec, res) == ("rejected", -1)
        assert est == pytest.approx(W + 0.01)

    def test_min_resolution_forbids_the_cheap_escape(self):
        # 0.04 covers est(0)=0.0367 but the client insists on >= 1
        # (est(1)=0.0567 does not fit): reject, don't serve junk
        dec, res, _ = AdmissionController.decide(
            0.04, 2, 1, 0.0, ARRIVAL, SERVICE, m=2, safety=1.0)
        assert (dec, res) == ("rejected", -1)
        dec0, res0, _ = AdmissionController.decide(
            0.04, 2, 0, 0.0, ARRIVAL, SERVICE, m=2, safety=1.0)
        assert (dec0, res0) == ("down-resolved", 0)

    def test_backlog_shifts_every_estimate(self):
        # +21 ms backlog: est(2)=0.0877 and est(1)=0.0777 both exceed
        # 0.07, est(0)=0.0577 fits
        dec, res, est = AdmissionController.decide(
            0.07, 2, 0, 0.021, ARRIVAL, SERVICE, m=2, safety=1.0)
        assert (dec, res) == ("down-resolved", 0)
        assert est == pytest.approx(0.021 + W + 0.01)

    def test_safety_inflates_the_estimate(self):
        # safety 2: 2*est(2)=0.133 and 2*est(1)=0.113 exceed 0.1,
        # 2*est(0)=0.0733 fits
        dec, res, _ = AdmissionController.decide(
            0.1, 2, 0, 0.0, ARRIVAL, SERVICE, m=2, safety=2.0)
        assert (dec, res) == ("down-resolved", 0)

    def test_unstable_queue_rejects_everything(self):
        # rho >= 1: Marchal's W is +inf, no deadline can cover it
        slow = Moments(0.2, 0.08)
        assert gg1_waiting_time(ARRIVAL, slow) == float("inf")
        dec, res, est = AdmissionController.decide(
            1e9, 2, 0, 0.0, ARRIVAL, slow, m=2, safety=1.0)
        assert (dec, res) == ("rejected", -1)
        assert est == float("inf")

    def test_requested_below_full_starts_the_walk_there(self):
        dec, res, _ = AdmissionController.decide(
            0.07, 1, 0, 0.0, ARRIVAL, SERVICE, m=2, safety=1.0)
        assert (dec, res) == ("admitted", 1)


class TestAdmissionController:
    def test_unknown_policy_raises(self):
        with pytest.raises(ValueError):
            AdmissionController(_cfg(), policy="lottery")

    def test_priors_until_min_samples(self):
        ctl = AdmissionController(_cfg())
        prior = ctl.service_moments()
        for _ in range(MIN_SAMPLES - 1):
            ctl.note_service(10.0)
        assert ctl.service_moments() == prior       # still the prior
        ctl.note_service(10.0)
        assert ctl.service_moments().mean == pytest.approx(10.0)

    def test_arrival_gaps_are_consecutive_differences(self):
        ctl = AdmissionController(_cfg())
        for i in range(MIN_SAMPLES + 1):
            ctl.note_arrival(0.5 * i)
        assert ctl.arrival_moments().mean == pytest.approx(0.5)

    def test_policy_none_admits_at_requested(self):
        # even a 1 ns deadline is admitted: pure load-generation mode
        ctl = AdmissionController(_cfg(), policy="none")
        dec, res, est = ctl.admit(1e-9, 2, 0, 0.0)
        assert (dec, res) == ("admitted", 2)
        assert est > 0.0


class TestGatewayLifecycle:
    def test_open_stream_releases_in_order_with_exact_values(self, rng):
        cfg = _cfg()
        with ServingGateway(cfg, admission="none") as gw:
            tickets, oracles = [], []
            for _ in range(3):
                a, b = _operands(rng, cfg)
                oracles.append(a.T @ b)
                tickets.append(gw.submit(a, b, deadline=30.0))
        stats = gw.stats
        stats.reconcile()
        assert stats.submitted == stats.admitted == stats.released == 3
        assert stats.rejected == stats.degraded == 0
        full = cfg.num_layers - 1
        assert stats.release_histogram == {full: 3}
        for t, want in zip(tickets, oracles):
            assert t.done.is_set()
            assert t.released_resolution == full and not t.degraded
            # the decode reconstructs in float64: integer-exact after
            # rounding off the accumulated scaling roundoff
            np.testing.assert_array_equal(
                np.round(t.value()).astype(np.int64), want)
        # FIFO: the shared fleet serves the stream in arrival order
        starts = [t.result.service_started_at for t in tickets]
        assert all(s is not None for s in starts)
        assert starts == sorted(starts)
        arrivals = [t.arrival for t in tickets]
        assert arrivals == sorted(arrivals)

    def test_rejection_is_immediate_and_valueless(self, rng):
        cfg = _cfg()
        with ServingGateway(cfg, admission="gg1") as gw:
            a, b = _operands(rng, cfg)
            t = gw.submit(a, b, deadline=1e-9)
            # priced against the modeled priors: nothing fits 1 ns
            assert t.decision == "rejected" and not t.admitted
            assert t.done.is_set()          # no waiting on a rejection
            assert t.released_resolution == -1 and t.result is None
            with pytest.raises(RuntimeError):
                t.value()
        gw.stats.reconcile()
        assert gw.stats.rejected == 1 and gw.stats.released == 0

    def test_degraded_or_admitted_release_under_pressure(self, rng):
        """Tight deadlines: each admitted request is still answered, at
        >= its admitted resolution or explicitly marked degraded."""
        cfg = _cfg(straggler="exp")
        with ServingGateway(cfg, admission="none") as gw:
            tickets = []
            for _ in range(4):
                a, b = _operands(rng, cfg, k=64, n=8)
                tickets.append(gw.submit(a, b, deadline=2e-3))
        gw.stats.reconcile()
        for t in tickets:
            assert t.done.is_set()
            assert t.degraded == (
                t.released_resolution < t.admitted_resolution)
            if not t.degraded:
                assert t.released_resolution >= t.admitted_resolution

    def test_stop_is_idempotent_and_closes_admission(self, rng):
        cfg = _cfg()
        gw = ServingGateway(cfg, admission="none").start()
        a, b = _operands(rng, cfg)
        gw.submit(a, b, deadline=30.0)
        stats = gw.stop()
        assert gw.stop() is stats           # second stop: no-op
        with pytest.raises(RuntimeError):
            gw.submit(a, b, deadline=30.0)  # admission is closed

    def test_shutdown_leaves_no_gateway_or_fleet_threads(self, rng):
        cfg = _cfg()
        gw = ServingGateway(cfg, admission="none").start()
        a, b = _operands(rng, cfg)
        gw.submit(a, b, deadline=30.0)
        gw.stop()
        leaked = [th.name for th in threading.enumerate()
                  if th.name.startswith(("gateway-", "runtime-"))]
        assert leaked == [], leaked

    def test_start_twice_raises(self):
        gw = ServingGateway(_cfg(), admission="none").start()
        try:
            with pytest.raises(RuntimeError):
                gw.start()
        finally:
            gw.stop()

    def test_submit_validation(self, rng):
        cfg = _cfg()
        a, b = _operands(rng, cfg)
        with ServingGateway(cfg, admission="none") as gw:
            with pytest.raises(ValueError):
                gw.submit(a, b, deadline=0.0)
            with pytest.raises(ValueError):
                gw.submit(a, b, deadline=1.0, resolution=cfg.num_layers)
            with pytest.raises(ValueError):
                gw.submit(a, b, deadline=1.0, resolution=1,
                          min_resolution=2)

    def test_stats_counters_reconcile_midstream(self, rng):
        cfg = _cfg()
        with ServingGateway(cfg, admission="none") as gw:
            a, b = _operands(rng, cfg)
            t = gw.submit(a, b, deadline=30.0)
            gw.stats.reconcile()            # valid while still in flight
            t.wait(timeout=30.0)
        gw.stats.reconcile()


class TestGatewayProperties:
    """Seeded arbitrary arrival schedules against the gateway contract:
    no starvation (every ticket finalized), every admitted request
    released by its deadline (+scheduling slop) at >= its admitted
    resolution or marked degraded, counters reconcile with the event
    log exactly."""

    @hypothesis.given(seed=st.integers(0, 2**16 - 1))
    @hypothesis.settings(max_examples=5, deadline=None)
    def test_no_starvation_and_exact_accounting(self, seed):
        rng = np.random.default_rng(seed)
        # arrival prior of 5/s keeps the modeled queue stable (rho < 1)
        # so generous deadlines actually admit; tight ones still reject
        cfg = _cfg(seed=seed, arrival_rate=5.0)
        n = int(rng.integers(2, 7))
        gaps = rng.exponential(0.005, size=n).clip(0.0, 0.02)
        deadlines = rng.choice([0.002, 0.05, 5.0], size=n)
        with ServingGateway(cfg, admission="gg1", safety=1.0) as gw:
            tickets = []
            for i in range(n):
                time.sleep(float(gaps[i]))
                a, b = _operands(rng, cfg)
                tickets.append(
                    gw.submit(a, b, deadline=float(deadlines[i]),
                              min_resolution=0))
        stats = gw.stats
        stats.reconcile()
        assert stats.submitted == n
        assert stats.released == stats.admitted
        for t in tickets:
            assert t.done.is_set()          # nobody starves
            if not t.admitted:
                assert t.released_resolution == -1
                continue
            # released by the deadline (modulo drain-thread scheduling)
            # unless the job's own release beat it
            assert t.released_at is not None
            assert (t.released_at <= t.deadline_at + 0.25
                    or t.released_resolution >= t.admitted_resolution)
            # the release contract: admitted resolution or degraded
            assert (t.released_resolution >= t.admitted_resolution
                    or t.degraded)
            if t.released_resolution >= 0:
                assert t.released_resolution < cfg.num_layers


def test_admission_verdicts_equal_the_jax_packages():
    """The same bound in both packages: every verdict, resolution and
    estimate over a grid of deadlines, backlogs and floors."""
    from repro.core.queueing import Moments as JMoments
    from repro.runtime.gateway import AdmissionController as JAdmission
    for deadline in (0.03, 0.04, 0.06, 0.07, 0.1):
        for backlog in (0.0, 0.021):
            for floor in (0, 1):
                got = AdmissionController.decide(
                    deadline, 2, floor, backlog, ARRIVAL, SERVICE, m=2,
                    safety=1.3)
                want = JAdmission.decide(
                    deadline, 2, floor, backlog, JMoments(0.1, 0.02),
                    JMoments(0.04, 0.0032), m=2, safety=1.3)
                assert got[:2] == want[:2]
                assert got[2] == pytest.approx(want[2])
    assert cumulative_minijobs(2) == [1, 3, 4]
