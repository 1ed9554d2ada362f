"""Port parity: the hierarchical code's decode, its properties and its
config surface, and the online omega policies and controller.

The cases of the JAX package's ``tests/test_hierarchical_coding.py``
(``TestHierarchicalDecodeFloat``, ``TestHierarchicalDecodeGfp``,
``TestHierarchicalProperties``, ``TestConfigSurface``) and
``tests/test_adaptive_omega.py`` (``TestPolicies``, ``TestController``)
on ``repro_torch.core.coding``, ``repro_torch.runtime.fusion``,
``repro_torch.runtime.tasks`` and ``repro_torch.runtime.adaptive``, with
the same cases and tolerances.  Each port function is also held against
the reference function on the same inputs: a level's decode of the same
coded products equals the reference's (within 1e-9 relative in float
mode, where both solve the same float64 system; bit for bit in gfp), and
a policy or controller fed the same observations takes the same steps
(omega, reason, geometry, eq. (1) split).
"""

import dataclasses
import itertools

import numpy as np
import pytest
from _hypothesis_compat import hypothesis, st

pytest.importorskip("jax")

from repro.core import coding as jcoding  # noqa: E402
from repro.runtime import RuntimeConfig as JRuntimeConfig  # noqa: E402
from repro.runtime import adaptive as jadaptive  # noqa: E402
from repro_torch.core import coding  # noqa: E402
from repro_torch.runtime.adaptive import (POLICIES, AIMDPolicy,  # noqa
                                          DeadlineMarginPolicy, FixedPolicy,
                                          OmegaController, RoundObservation,
                                          make_policy)
from repro_torch.runtime.fusion import FusionNode  # noqa: E402
from repro_torch.runtime.tasks import (RoundContext, RuntimeConfig,  # noqa
                                       TaskResult)

MU3 = (400.0, 650.0, 380.0)


# ---------------------------------------------------------------------------
# The hierarchical code
# ---------------------------------------------------------------------------

def _all_task_products(code, A, B):
    """Every coded symbol's product for one level, stacked (T, ...)."""
    X, Y = np.asarray(code.encode_a(A)), np.asarray(code.encode_b(B))
    return np.stack([X[t].T @ Y[t] for t in range(code.num_tasks)])


def _decode(hc, jhc, lvl, ids, prods):
    """The port's decode of level ``lvl`` from ``ids``, held against the
    reference's decode of the same products."""
    got = np.asarray(hc.decode_level(lvl, list(ids), prods[np.asarray(ids)]))
    want = np.asarray(jhc.decode_level(lvl, list(ids),
                                       prods[np.asarray(ids)]))
    if hc.mode == "gfp":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-9,
                                   atol=1e-9 * np.abs(want).max())
    return got


def _codes(**kw):
    return coding.HierarchicalCode(**kw), jcoding.HierarchicalCode(**kw)


class TestHierarchicalDecodeFloat:
    def test_hand_computed_two_level_decode(self):
        hc, jhc = _codes(n1=2, n2=1, levels=2, omega=1.5)
        assert hc.level_lengths == jhc.level_lengths == (4, 2)
        A = np.array([[1.0, 2.0], [3.0, 4.0]])
        B = np.array([[5.0], [6.0]])
        want = np.array([[1 * 5 + 3 * 6], [2 * 5 + 4 * 6]])
        for lvl in range(2):
            code = hc.level_code(lvl)
            prods = _all_task_products(code, A, B)
            np.testing.assert_allclose(
                prods, _all_task_products(jhc.level_code(lvl), A, B),
                rtol=1e-12)
            for ids in itertools.combinations(range(code.num_tasks), hc.k):
                dec = _decode(hc, jhc, lvl, ids, prods)
                np.testing.assert_allclose(dec, want, rtol=1e-9, atol=1e-9)

    def test_any_k_subset_every_level(self, rng):
        hc, jhc = _codes(n1=2, n2=2, levels=3, omega=1.5)
        A = rng.integers(-100, 100, size=(16, 8)).astype(np.float64)
        B = rng.integers(-100, 100, size=(16, 8)).astype(np.float64)
        exact = A.T @ B
        for lvl in range(hc.levels):
            code = hc.level_code(lvl)
            prods = _all_task_products(code, A, B)
            subsets = [list(range(hc.k)),
                       list(range(code.num_tasks - hc.k, code.num_tasks)),
                       list(rng.choice(code.num_tasks, hc.k,
                                       replace=False))]
            for ids in subsets:
                dec = _decode(hc, jhc, lvl, ids, prods)
                np.testing.assert_allclose(dec, exact, rtol=1e-8, atol=1e-6)

    def test_same_subset_any_order_bit_identical(self, rng):
        hc, jhc = _codes(n1=2, n2=2, levels=2, omega=1.5)
        A = rng.normal(size=(16, 8))
        B = rng.normal(size=(16, 8))
        for lvl in range(hc.levels):
            code = hc.level_code(lvl)
            prods = _all_task_products(code, A, B)
            ids = list(rng.choice(code.num_tasks, hc.k, replace=False))
            base = _decode(hc, jhc, lvl, ids, prods)
            for _ in range(4):
                perm = list(rng.permutation(len(ids)))
                pids = [ids[i] for i in perm]
                dec = _decode(hc, jhc, lvl, pids, prods)
                assert base.tobytes() == dec.tobytes()

    def test_shared_plan_cache_across_equal_lengths(self):
        hc = coding.HierarchicalCode(n1=2, n2=2, levels=2, omega=1.0)
        assert hc.plan(0) is hc.plan(1)
        flat = coding.PolynomialCode(n1=2, n2=2, omega=1.0)
        assert hc.plan(0) is flat.plan()


class TestHierarchicalDecodeGfp:
    def test_every_subset_bit_exact(self, rng):
        hc, jhc = _codes(n1=2, n2=1, levels=2, omega=1.5, mode="gfp")
        A = rng.integers(0, 255, size=(16, 6)).astype(np.uint64)
        B = rng.integers(0, 255, size=(16, 3)).astype(np.uint64)
        exact = A.astype(np.int64).T @ B.astype(np.int64)
        for lvl in range(hc.levels):
            code = hc.level_code(lvl)
            X, Y = code.encode(A, B)
            tasks = np.asarray(code.compute_all_tasks(X, Y))
            jX, jY = jhc.level_code(lvl).encode(A, B)
            np.testing.assert_array_equal(
                tasks, np.asarray(jhc.level_code(lvl).compute_all_tasks(
                    jX, jY)))
            for ids in itertools.combinations(range(code.num_tasks), hc.k):
                dec = _decode(hc, jhc, lvl, ids, tasks)
                np.testing.assert_array_equal(dec, exact)


class TestHierarchicalProperties:
    """Hypothesis property block (skips without hypothesis installed)."""

    @hypothesis.given(st.integers(1, 3), st.integers(1, 2),
                      st.integers(2, 4),
                      st.floats(1.0, 2.0, allow_nan=False),
                      st.integers(0, 2 ** 16))
    @hypothesis.settings(max_examples=30, deadline=None)
    def test_any_level_any_subset_decodes(self, n1, n2, levels, omega,
                                          seed):
        rng = np.random.default_rng(seed)
        hc, jhc = _codes(n1=n1, n2=n2, levels=levels, omega=omega)
        assert hc.level_lengths == jhc.level_lengths
        A = rng.integers(-50, 50, size=(8, 4 * n1)).astype(np.float64)
        B = rng.integers(-50, 50, size=(8, 4 * n2)).astype(np.float64)
        exact = A.T @ B
        lvl = int(rng.integers(hc.levels))
        code = hc.level_code(lvl)
        prods = _all_task_products(code, A, B)
        ids = list(rng.choice(code.num_tasks, hc.k, replace=False))
        dec = _decode(hc, jhc, lvl, ids, prods)
        np.testing.assert_allclose(dec, exact, rtol=1e-7, atol=1e-5)
        perm = [ids[i] for i in rng.permutation(len(ids))]
        dec2 = np.asarray(hc.decode_level(lvl, perm,
                                          prods[np.asarray(perm)]))
        assert dec.tobytes() == dec2.tobytes()

    @hypothesis.given(st.integers(2, 4), st.integers(1, 5),
                      st.integers(0, 2 ** 16))
    @hypothesis.settings(max_examples=30, deadline=None)
    def test_partial_level_never_corrupts_siblings(self, levels, short_by,
                                                   seed):
        rng = np.random.default_rng(seed)
        hc = coding.HierarchicalCode(n1=2, n2=2, levels=levels, omega=1.5)
        A = rng.integers(-50, 50, size=(8, 8)).astype(np.float64)
        B = rng.integers(-50, 50, size=(8, 8)).astype(np.float64)
        exact = A.T @ B
        starved = int(rng.integers(levels))
        fusion = FusionNode()
        ctxs = [RoundContext(job_id=0, round_idx=l) for l in range(levels)]
        rfs = fusion.begin_group(ctxs, hc.k)
        for lvl in range(levels):
            code = hc.level_code(lvl)
            prods = _all_task_products(code, A, B)
            n_post = (max(0, hc.k - short_by) if lvl == starved else hc.k)
            ids = rng.choice(code.num_tasks, hc.k, replace=False)[:n_post]
            for tid in ids:
                assert fusion.post(TaskResult(
                    job_id=0, round_idx=lvl, task_id=int(tid), worker_id=0,
                    value=prods[tid], finished_at=0.0))
        for lvl in range(levels):
            if lvl == starved:
                assert not rfs[lvl].wait(0.0)
                continue
            assert rfs[lvl].wait(0.0)
            dec = np.asarray(rfs[lvl].decode(hc.level_code(lvl)))
            np.testing.assert_allclose(dec, exact, rtol=1e-8, atol=1e-6)
        fusion.end_group()
        assert fusion.stale_results == 0


class TestConfigSurface:
    def test_hier_config_round_trip(self):
        kw = dict(mu=(1.0, 1.0, 1.0, 1.0), n1=2, n2=2, omega=1.5,
                  code_family="hierarchical", levels=2)
        cfg = RuntimeConfig(**kw)
        hc = cfg.hier_code()
        assert isinstance(hc, coding.HierarchicalCode)
        assert hc.levels == 2 and hc.k == cfg.k
        assert hc.level_lengths == JRuntimeConfig(**kw).hier_code(
        ).level_lengths

    @pytest.mark.parametrize("kw,match", [
        (dict(levels=3), "levels"),
        (dict(code_family="hierarchical", levels=1), "levels"),
        (dict(backend="process", shm="on", code_family="hierarchical",
              levels=2), "shm"),
        (dict(code_family="fountain"), "code family")],
        ids=["polynomial_rejects_levels", "hierarchical_requires_levels",
             "hierarchical_rejects_forced_shm", "unknown_family_rejected"])
    def test_config_rejects(self, kw, match):
        for cls in (RuntimeConfig, JRuntimeConfig):
            with pytest.raises(ValueError, match=match):
                cls(mu=(1.0,) * 4, **kw)


# ---------------------------------------------------------------------------
# Online omega control
# ---------------------------------------------------------------------------

def obs(round_idx=0, *, wait=0.01, fused=True, stale=0, margin=None,
        rounds_left=3, job_id=0):
    return RoundObservation(round_idx=round_idx, job_id=job_id, wait=wait,
                            fused=fused, stale=stale,
                            deadline_margin=margin, rounds_left=rounds_left)


class _Twin:
    """A port policy and the reference's twin of it, stepped together on
    the same observations: every step must agree."""

    def __init__(self, name, **kw):
        self.pol = {"fixed": FixedPolicy, "aimd": AIMDPolicy,
                    "deadline-margin": DeadlineMarginPolicy}[name](**kw)
        self.ref = jadaptive.POLICIES[name](**kw)

    def step(self, o, omega):
        got = self.pol.step(o, omega)
        want = self.ref.step(jadaptive.RoundObservation(
            **dataclasses.asdict(o)), omega)
        assert got == want
        return got


class TestPolicies:
    def test_fixed_never_moves(self):
        pol = _Twin("fixed")
        for i in range(10):
            omega, reason = pol.step(obs(i, fused=(i % 2 == 0), stale=50,
                                         margin=0.0), 1.5)
            assert omega == 1.5 and reason is None

    def test_aimd_grows_on_missed_deadline(self):
        omega, reason = _Twin("aimd", increase=0.25).step(obs(fused=False),
                                                          1.0)
        assert omega == 1.25 and "missed" in reason

    def test_aimd_grows_on_projected_miss(self):
        omega, reason = _Twin("aimd", increase=0.25).step(
            obs(wait=0.02, margin=0.01, rounds_left=3), 1.0)
        assert omega == 1.25 and "projected" in reason

    def test_aimd_shrinks_multiplicatively_on_stale_pileup(self):
        pol = _Twin("aimd", decrease=0.8, stale_tolerance=1.0)
        omega = 2.0
        for i in range(12):
            omega, reason = pol.step(obs(i, stale=3), omega)
            if reason is not None:
                assert "stale" in reason
                assert omega == pytest.approx(2.0 * 0.8)
                return
        pytest.fail("stale pile-up never triggered a shrink")

    def test_aimd_comfortable_round_is_a_noop(self):
        omega, reason = _Twin("aimd").step(
            obs(wait=0.001, margin=1.0, rounds_left=3, stale=0), 1.5)
        assert omega == 1.5 and reason is None

    def test_deadline_margin_grows_when_band_undershot(self):
        omega, reason = _Twin("deadline-margin", low=1.5,
                              step_up=0.25).step(
            obs(wait=0.01, margin=0.012, rounds_left=1), 1.0)
        assert omega == 1.25 and "margin ratio" in reason

    def test_deadline_margin_shrinks_only_when_comfortable(self):
        kw = dict(high=6.0, step_down=0.125, stale_tolerance=1.0)
        omega, reason = _Twin("deadline-margin", **kw).step(
            obs(wait=0.01, margin=0.02, rounds_left=1, stale=10), 2.0)
        assert omega >= 2.0
        omega, reason = _Twin("deadline-margin", **kw).step(
            obs(wait=0.001, margin=0.1, rounds_left=1, stale=10), 2.0)
        assert omega == pytest.approx(2.0 - 0.125) and "stale" in reason

    def test_deadline_margin_grows_on_realized_miss(self):
        omega, reason = _Twin("deadline-margin", step_up=0.25).step(
            obs(fused=False), 1.0)
        assert omega == 1.25 and "missed" in reason

    @pytest.mark.parametrize("name", ["aimd", "deadline-margin"])
    def test_policies_grow_without_a_deadline_on_wait_spike(self, name):
        pol = _Twin(name)
        for i in range(5):
            omega, _ = pol.step(obs(i, wait=0.005), 1.5)
            assert omega == 1.5
        omega, reason = pol.step(obs(9, wait=0.5), 1.5)
        assert omega > 1.5 and "spike" in reason

    def test_make_policy_resolves_names_and_instances(self):
        assert isinstance(make_policy("aimd"), AIMDPolicy)
        pol = DeadlineMarginPolicy()
        assert make_policy(pol) is pol
        assert isinstance(make_policy(None), FixedPolicy)
        with pytest.raises(ValueError, match="unknown omega policy"):
            make_policy("bogus")
        assert set(POLICIES) == set(jadaptive.POLICIES) == {
            "fixed", "aimd", "deadline-margin"}


def _trace(ctrl):
    """A controller's trace less its measured seconds."""
    return [{k: v for k, v in ev.items() if k != "prime_seconds"}
            for ev in ctrl.trace]


class _Controllers:
    """A port controller and the reference's on the same config, fed the
    same observations: every decision, geometry and split agrees."""

    def __init__(self, aimd=None, **kw):
        """``aimd``: the keywords of an ``AIMDPolicy`` given to both, in
        place of the config's policy."""
        self.ctrl = OmegaController(
            RuntimeConfig(**kw), policy=aimd and AIMDPolicy(**aimd))
        self.ref = jadaptive.OmegaController(
            JRuntimeConfig(**kw), policy=aimd and jadaptive.AIMDPolicy(**aimd))

    def observe(self, o):
        got = self.ctrl.observe(o)
        want = self.ref.observe(jadaptive.RoundObservation(
            **dataclasses.asdict(o)))
        assert got == want
        assert self.ctrl.omega == self.ref.omega
        assert self.ctrl.total_tasks == self.ref.total_tasks
        np.testing.assert_array_equal(self.ctrl.kappa, self.ref.kappa)
        assert _trace(self.ctrl) == _trace(self.ref)
        return got


class TestController:
    def _kw(self, **kw):
        kw.setdefault("mu", MU3)
        kw.setdefault("omega", 1.0)
        kw.setdefault("adapt", "aimd")
        return kw

    def test_bounds_respected(self):
        c = _Controllers(**self._kw(omega_min=1.0, omega_max=1.5))
        for i in range(20):
            c.observe(obs(i, fused=False))
        assert c.ctrl.omega == 1.5
        assert all(ev["omega_new"] <= 1.5 for ev in c.ctrl.trace)
        c2 = _Controllers(**self._kw(omega=1.0, omega_min=1.0))
        for i in range(40):
            c2.observe(obs(i, stale=10))
        assert c2.ctrl.omega >= 1.0

    def test_geometry_switch_rebuilds_kappa_and_traces_prime(self):
        c = _Controllers(**self._kw())
        ctrl = c.ctrl
        assert ctrl.total_tasks == 4 and ctrl.kappa.sum() == 4
        switched = c.observe(obs(fused=False))
        assert switched and ctrl.total_tasks == 5
        assert ctrl.kappa.sum() == 5
        assert ctrl.switches == 1
        ev = ctrl.trace[-1]
        assert ev["switched"] and ev["T_old"] == 4 and ev["T_new"] == 5
        assert ev["prime_seconds"] >= 0.0
        assert ctrl.summary()["omega_final"] == 1.25

    def test_omega_move_within_codeword_bucket_switches_nothing(self):
        c = _Controllers(aimd=dict(decrease=0.85, stale_tolerance=0.5),
                         **self._kw(omega=1.5, adapt="aimd"))
        ctrl = c.ctrl
        code_before = ctrl.code
        switched = c.observe(obs(stale=10))
        assert ctrl.omega == pytest.approx(1.275)
        assert not switched and ctrl.switches == 0
        assert ctrl.code is code_before
        assert len(ctrl.trace) == 1 and not ctrl.trace[-1]["switched"]

    def test_decode_plan_reused_across_geometry_round_trip(self):
        c = _Controllers(**self._kw(omega=1.0))
        ctrl = c.ctrl
        plan_t4 = ctrl.code.plan()
        c.observe(obs(0, fused=False))
        plan_t5 = ctrl.code.plan()
        assert plan_t5 is not plan_t4
        for i in range(1, 60):
            c.observe(obs(i, stale=10))
            if ctrl.total_tasks == 4:
                break
        assert ctrl.total_tasks == 4
        assert ctrl.code.plan() is plan_t4
        cfg_raw = RuntimeConfig(mu=MU3)
        assert (cfg_raw.code(omega=1.3).plan()
                is cfg_raw.code(omega=1.5).plan())
        ids = tuple(range(4))
        plan_t4.solve(ids, np.zeros((4, 2, 2)))
        hits_before = plan_t4.cache_info()["hits"]
        plan_t4.solve(ids, np.zeros((4, 2, 2)))
        assert plan_t4.cache_info()["hits"] == hits_before + 1

    def test_fixed_controller_is_static(self):
        c = _Controllers(mu=MU3, omega=1.5)
        for i in range(10):
            assert not c.observe(obs(i, fused=False, stale=50))
        assert c.ctrl.omega == 1.5 and c.ctrl.trace == []
        s = c.ctrl.summary()
        assert s["policy"] == "fixed" and s["retunes"] == 0

    def test_initial_omega_clipped_into_bounds(self):
        c = _Controllers(**self._kw(omega=1.2, omega_min=1.5,
                                    omega_max=2.0))
        assert c.ctrl.omega == c.ref.omega == 1.5

    def test_fixed_policy_ignores_inert_adaptive_bounds(self):
        c = _Controllers(mu=MU3, omega=4.0)
        assert c.ctrl.omega == c.ref.omega == 4.0
        assert c.ctrl.total_tasks == RuntimeConfig(mu=MU3, omega=4.0
                                                   ).total_tasks == 16

    def test_config_rejects_bad_bounds_and_bursts(self):
        for cls in (RuntimeConfig, JRuntimeConfig):
            with pytest.raises(ValueError, match="omega_min"):
                cls(mu=MU3, omega_min=2.0, omega_max=1.5)
            with pytest.raises(ValueError, match="burst_len"):
                cls(mu=MU3, straggler="burst", burst_len=2.0,
                    burst_period=1.0, stall_workers=(1,))
            for mode in ("shift", "burst"):
                with pytest.raises(ValueError, match="stall_workers"):
                    cls(mu=MU3, straggler=mode)
