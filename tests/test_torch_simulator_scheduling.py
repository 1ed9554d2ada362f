"""Port parity: the §IV event simulator's deadline rule, eq. (1)'s load
split and the eqs. (2)-(4) G/G/1 bounds.

The cases of the JAX package's ``tests/test_simulator_deadline.py``
(``TestTerminationRule``, ``TestPaperRegime``) and
``tests/test_scheduling_queueing.py`` (``TestLoadSplit``,
``TestQueueingTheory``, ``TestSimulator``) on ``repro_torch.core``'s
``simulator``, ``scheduling`` and ``queueing``, with the same cases and
tolerances.  Each port function is also held against the reference
function on the same arguments: both packages draw from the same NumPy
generators and run the same float64 arithmetic, so every simulated array,
load split and bound is equal, bit for bit.
"""

import dataclasses

import numpy as np
import pytest
from _hypothesis_compat import hypothesis, st

pytest.importorskip("jax")

from repro.core import queueing as jqueueing  # noqa: E402
from repro.core import scheduling as jscheduling  # noqa: E402
from repro.core import simulator as jsimulator  # noqa: E402
from repro_torch.core import layering, queueing, scheduling  # noqa: E402
from repro_torch.core import simulator  # noqa: E402

_FIELDS = ("arrivals", "starts", "ends", "layer_compute", "success",
           "terminated", "kappa")


def _sim(cfg, num_jobs, **kw):
    """``simulator.simulate`` on the port, held field by field against the
    reference's on the same config; returns the port's result."""
    got = simulator.simulate(cfg, num_jobs, **kw)
    want = jsimulator.simulate(
        jsimulator.SystemConfig(**dataclasses.asdict(cfg)), num_jobs, **kw)
    for name in _FIELDS:
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), err_msg=name)
    np.testing.assert_array_equal(got.mean_delay(), want.mean_delay())
    np.testing.assert_array_equal(got.success_rate(), want.success_rate())
    return got


def _cfg(**kw):
    base = dict(mu=(385.95, 650.92, 373.40, 415.75, 373.98),
                arrival_rate=0.01, k=1000, complexity=50.0, m=2,
                omega=1.06)
    base.update(kw)
    return simulator.SystemConfig(**base)


def _jmoments(m):
    return jqueueing.Moments(m.mean, m.second_moment)


class TestTerminationRule:
    def test_deadline_excess_alone_does_not_terminate(self):
        cfg = _cfg(arrival_rate=1e-6)
        res = _sim(cfg, 50, layered=True, deadline=1e-3, seed=0)
        assert res.layer_compute[:, -1].min() > 1e-3
        assert not res.terminated.any()
        assert res.success.all()

    def test_queued_successor_alone_does_not_terminate(self):
        cfg = _cfg(arrival_rate=10.0)
        res = _sim(cfg, 50, layered=True, deadline=1e9, seed=0)
        assert not res.terminated.any()
        assert res.success.all()

    def test_both_conditions_terminate(self):
        cfg = _cfg(arrival_rate=10.0)
        res = _sim(cfg, 200, layered=True, deadline=1e-3, seed=0)
        assert res.terminated.any()

    def test_last_job_never_terminated(self):
        cfg = _cfg(arrival_rate=10.0)
        res = _sim(cfg, 100, layered=True, deadline=1e-3, seed=1)
        assert res.terminated[:-1].any()
        assert not res.terminated[-1]
        assert res.success[-1].all()

    def test_termination_at_next_arrival_not_before(self):
        cfg = _cfg(arrival_rate=0.005)
        res = _sim(cfg, 300, layered=True, deadline=1.0, seed=2)
        term = np.flatnonzero(res.terminated)
        assert term.size > 0
        next_arrivals = res.arrivals[term + 1]
        assert np.all(res.ends[term] >= next_arrivals - 1e-9)
        assert np.all(res.ends[term] >= res.starts[term] + 1.0 - 1e-9)


class TestPaperRegime:
    def test_resolution0_success_rate_is_one(self):
        cfg = _cfg(omega=1.018)
        res = _sim(cfg, 2000, layered=True, deadline=10.0, seed=0)
        sr = res.success_rate()
        assert sr[0] == pytest.approx(1.0)
        assert sr[-1] < 1.0
        assert np.all(np.diff(sr) <= 1e-12)

    def test_layered_beats_unlayered_under_deadline(self):
        cfg = _cfg(omega=1.018)
        lay = _sim(cfg, 1000, layered=True, deadline=10.0, seed=0)
        unlay = _sim(cfg, 1000, layered=False, deadline=10.0, seed=0)
        assert lay.success_rate()[0] > unlay.success_rate()[0]

    def test_mean_delay_ordered_msb_first(self):
        res = _sim(_cfg(), 1000, layered=True, seed=0)
        assert np.all(np.diff(res.mean_delay()) > 0)


def _split(stats, total):
    """``scheduling.load_split`` on the port, equal to the reference's."""
    got = scheduling.load_split(stats, total)
    want = jscheduling.load_split(
        [jscheduling.WorkerStats(**dataclasses.asdict(s)) for s in stats],
        total)
    np.testing.assert_array_equal(got, want)
    return got


class TestLoadSplit:
    def test_sums_exactly(self):
        stats = [scheduling.worker_job_moments(mu, 1000, 50.0)
                 for mu in simulator.PAPER_SYSTEM.mu]
        assert [dataclasses.asdict(s) for s in stats] == [
            dataclasses.asdict(jscheduling.worker_job_moments(mu, 1000, 50.0))
            for mu in jsimulator.PAPER_SYSTEM.mu]
        for total in [1000, 1018, 1060, 1200]:
            kappa = _split(stats, total)
            assert kappa.sum() == total
            assert (kappa >= 0).all()

    def test_faster_worker_gets_more(self):
        stats = [scheduling.worker_job_moments(mu, 1000, 50.0)
                 for mu in (100.0, 400.0)]
        kappa = _split(stats, 500)
        assert kappa[1] > kappa[0]

    def test_homogeneous_split_is_even(self):
        stats = [scheduling.worker_job_moments(200.0, 100, 10.0)] * 4
        kappa = _split(stats, 100)
        assert kappa.max() - kappa.min() <= 1

    @hypothesis.given(st.lists(st.floats(50.0, 1000.0), min_size=1,
                               max_size=8),
                      st.integers(1, 5000))
    @hypothesis.settings(max_examples=50, deadline=None)
    def test_property_sum_and_nonneg(self, mus, total):
        stats = [scheduling.worker_job_moments(mu, 100, 10.0) for mu in mus]
        kappa = _split(stats, total)
        assert kappa.sum() == total and (kappa >= 0).all()

    def test_zero_and_errors(self):
        stats = [scheduling.worker_job_moments(100.0, 10, 1.0)]
        assert _split(stats, 0).sum() == 0
        for mod in (scheduling, jscheduling):
            with pytest.raises(ValueError):
                mod.load_split([], 10)


def _both(name, *args):
    """``queueing.<name>(*args)`` on the port, equal to the reference's
    (``Moments`` arguments carried across)."""
    got = getattr(queueing, name)(*args)
    want = getattr(jqueueing, name)(*[
        _jmoments(a) if isinstance(a, queueing.Moments) else a
        for a in args])
    np.testing.assert_array_equal(got, want)
    return got


class TestQueueingTheory:
    def test_service_rate_bound(self):
        assert _both("service_rate_bound", [2.0, 2.0]) == pytest.approx(1.0)

    def test_gg1_reduces_to_mm1(self):
        lam, mu = 0.5, 1.0
        arrival = queueing.Moments(1 / lam, 2 / lam**2)
        service = queueing.Moments(1 / mu, 2 / mu**2)
        assert _both("gg1_delay", arrival, service) == pytest.approx(
            1.0 / (mu - lam), rel=1e-6)

    def test_unstable_queue_is_inf(self):
        arrival = queueing.Moments(1.0, 2.0)
        service = queueing.Moments(2.0, 8.0)
        assert _both("gg1_delay", arrival, service) == np.inf

    def test_layered_bounds_monotone(self):
        cfg = simulator.PAPER_SYSTEM
        service = queueing.Moments(22.7, 22.7**2 * 1.01)
        arrival = queueing.Moments(100.0, 2 * 100.0**2)
        worker_means = [cfg.k * cfg.complexity / mu for mu in cfg.mu]
        b = _both("layered_delay_bounds", cfg.m, worker_means, arrival,
                  service)
        assert b.shape == (3,)
        assert b[0] < b[1] < b[2]

    def test_waiting_time_mm1_closed_form(self):
        lam, mu = 0.4, 1.0
        arrival = queueing.Moments(1 / lam, 2 / lam**2)
        service = queueing.Moments(1 / mu, 2 / mu**2)
        rho = lam / mu
        assert _both("gg1_waiting_time", arrival, service) == pytest.approx(
            rho / (mu - lam), rel=1e-9)

    def test_waiting_time_md1_closed_form(self):
        lam, mu = 0.5, 1.0
        arrival = queueing.Moments(1 / lam, 2 / lam**2)
        service = queueing.Moments(1 / mu, 1 / mu**2)
        rho = lam / mu
        assert _both("gg1_waiting_time", arrival, service) == pytest.approx(
            rho / (2 * (mu - lam)), rel=1e-9)

    def test_delay_decomposes_into_service_plus_wait(self):
        arrival = queueing.Moments(3.0, 2 * 9.0)
        service = queueing.Moments(1.2, 2.0)
        assert _both("gg1_delay", arrival, service) == pytest.approx(
            service.mean + _both("gg1_waiting_time", arrival, service))
        assert _both("gg1_delay", arrival, service, 0.9) == pytest.approx(
            0.9 + _both("gg1_waiting_time", arrival, service))

    def test_layered_bounds_decompose(self):
        m = 3
        worker_means = [0.05, 0.08, 0.04]
        arrival = queueing.Moments(0.5, 0.6)
        service = queueing.Moments(0.02, 0.0009)
        b = _both("layered_delay_bounds", m, worker_means, arrival, service)
        w = _both("gg1_waiting_time", arrival, service)
        rate = _both("service_rate_bound", worker_means)
        cum = np.asarray(layering.cumulative_minijobs(m), dtype=np.float64)
        np.testing.assert_allclose(b, cum / (m * m) / rate + w, rtol=1e-12)
        assert (np.diff(b) > 0).all()

    def test_waiting_time_zero_at_zero_variability(self):
        arrival = queueing.Moments(2.0, 4.0)
        service = queueing.Moments(1.0, 1.0)
        assert _both("gg1_waiting_time", arrival, service) == 0.0


class TestSimulator:
    def test_paper_shape_of_results(self):
        r = _sim(simulator.PAPER_SYSTEM, 200, layered=True, seed=0)
        assert r.layer_compute.shape == (200, 3)
        assert (np.diff(r.layer_compute, axis=1) >= 0).all()
        assert not r.terminated.any()
        assert r.success.all()

    def test_layer_delays_ordered_and_final_matches_unlayered(self):
        cfg = simulator.PAPER_SYSTEM
        r = _sim(cfg, 400, layered=True, seed=1)
        rn = _sim(cfg, 400, layered=False, seed=1)
        d = r.mean_delay()
        assert d[0] < d[1] < d[2]
        assert abs(d[2] - rn.mean_delay()[0]) / d[2] < 0.05

    def test_theory_bound_is_lower_bound_and_tight(self):
        cfg = simulator.SystemConfig(omega=1.06)
        r = _sim(cfg, 600, layered=True, seed=2)
        bounds = simulator.theory_bounds(cfg, r.service_moments(),
                                         layered=True)
        want = jsimulator.theory_bounds(
            jsimulator.SystemConfig(omega=1.06),
            _jmoments(r.service_moments()), layered=True)
        np.testing.assert_array_equal(bounds, want)
        d = r.mean_delay()
        assert (d >= bounds - 1e-9).all()
        assert ((d - bounds) / bounds < 0.08).all()

    def test_deadline_layer0_survives(self):
        r = _sim(simulator.PAPER_SYSTEM, 300, layered=True, deadline=10.0,
                 seed=3)
        sr = r.success_rate()
        assert sr[0] == 1.0
        assert sr[2] < 1.0
        assert (np.diff(sr) <= 1e-9).all()

    def test_deadline_requires_queued_successor(self):
        cfg = simulator.SystemConfig(arrival_rate=1e-5)
        r = _sim(cfg, 50, layered=True, deadline=1.0, seed=4)
        assert not r.terminated.any()

    def test_more_redundancy_not_slower(self):
        d1 = _sim(simulator.SystemConfig(omega=1.0), 400,
                  seed=5).mean_delay()[-1]
        d2 = _sim(simulator.SystemConfig(omega=1.1), 400,
                  seed=5).mean_delay()[-1]
        assert d2 <= d1 * 1.02

    def test_kappa_used_matches_eq1(self):
        cfg = simulator.PAPER_SYSTEM
        r = _sim(cfg, 10, layered=True, seed=6)
        assert r.kappa.sum() == cfg.total_tasks
