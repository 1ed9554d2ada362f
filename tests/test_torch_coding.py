"""Port parity: ``repro_torch.core.coding`` against ``repro.core.coding``.

Float mode is held against the JAX package's float64 host path (its
device einsum is float32 unless x64 is on); the GF(p) path must be
bit-exact.
"""

import itertools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from repro.core import coding as jc  # noqa: E402
from repro_torch.core import coding as tc  # noqa: E402

GEOMETRIES = [(2, 2, 1.0), (2, 2, 1.5), (4, 2, 1.25), (3, 3, 1.2)]


def _ints(rng, shape, hi=255):
    return rng.integers(0, hi, size=shape).astype(np.float64)


@pytest.mark.parametrize("n1,n2,omega", GEOMETRIES)
def test_encode_decode_match_jax_host_path(rng, n1, n2, omega):
    a = _ints(rng, (32, 4 * n1))
    b = _ints(rng, (32, 4 * n2))
    jcode = jc.PolynomialCode(n1=n1, n2=n2, omega=omega)
    tcode = tc.PolynomialCode(n1=n1, n2=n2, omega=omega)
    assert tcode.num_tasks == jcode.num_tasks
    np.testing.assert_array_equal(tcode.points(), jcode.points())
    X, Y = tcode.encode_a(a), tcode.encode_b(b)
    np.testing.assert_allclose(X, jcode.encode_a(a), rtol=1e-12)
    np.testing.assert_allclose(Y, jcode.encode_b(b), rtol=1e-12)
    tasks = np.stack([X[t].T @ Y[t] for t in range(tcode.num_tasks)])
    ids = list(range(tcode.num_tasks - tcode.k, tcode.num_tasks))
    got = tcode.decode(ids, tasks[ids])
    np.testing.assert_allclose(got, jcode.decode(ids, tasks[ids]),
                               rtol=1e-12)
    np.testing.assert_allclose(got, a.T @ b, rtol=1e-9, atol=1e-6)


@pytest.mark.parametrize("n1,n2,omega", GEOMETRIES[1:3])
def test_tensor_encode_is_float64_and_matches_host(rng, n1, n2, omega):
    """The device branch encodes torch tensors in float64 on their device
    (CPU here), agreeing with the NumPy host path."""
    a = _ints(rng, (24, 2 * n1))
    b = _ints(rng, (24, 2 * n2))
    code = tc.PolynomialCode(n1=n1, n2=n2, omega=omega)
    X, Y = code.encode(torch.from_numpy(a).to(torch.int32),
                       torch.from_numpy(b).to(torch.int32))
    assert X.dtype == torch.float64 and X.device.type == "cpu"
    np.testing.assert_allclose(X.numpy(), code.encode_a(a), rtol=1e-12)
    np.testing.assert_allclose(Y.numpy(), code.encode_b(b), rtol=1e-12)
    tasks = code.compute_all_tasks(X, Y)
    want = np.stack([code.encode_a(a)[t].T @ code.encode_b(b)[t]
                     for t in range(code.num_tasks)])
    np.testing.assert_allclose(tasks.numpy(), want, rtol=1e-12)


def test_every_k_subset_decodes(rng):
    code = tc.PolynomialCode(n1=2, n2=2, omega=1.5)
    jcode = jc.PolynomialCode(n1=2, n2=2, omega=1.5)
    a, b = _ints(rng, (16, 6)), _ints(rng, (16, 4))
    X, Y = code.encode(a, b)
    tasks = np.stack([X[t].T @ Y[t] for t in range(code.num_tasks)])
    exact = a.T @ b
    subsets = list(itertools.combinations(range(code.num_tasks), code.k))
    assert len(subsets) == 15
    for ids in subsets:
        ids = list(ids)
        got = code.decode(ids, tasks[ids])
        np.testing.assert_allclose(got, jcode.decode(ids, tasks[ids]),
                                   rtol=1e-12)
        np.testing.assert_allclose(got, exact, rtol=1e-9, atol=1e-6)
    # arrival order never matters: a permutation decodes the same
    perm = [5, 0, 3, 2]
    np.testing.assert_allclose(code.decode(perm, tasks[perm]), exact,
                               rtol=1e-9, atol=1e-6)


def test_gfp_path_bit_exact(rng):
    jcode = jc.PolynomialCode(n1=2, n2=2, omega=1.5, mode="gfp")
    tcode = tc.PolynomialCode(n1=2, n2=2, omega=1.5, mode="gfp")
    a = rng.integers(0, 1 << 12, size=(16, 6)).astype(np.uint64)
    b = rng.integers(0, 1 << 12, size=(16, 4)).astype(np.uint64)
    X, Y = tcode.encode(a, b)
    jX, jY = jcode.encode(a, b)
    np.testing.assert_array_equal(X, jX)
    np.testing.assert_array_equal(Y, jY)
    tasks = tcode.compute_all_tasks(X, Y)
    np.testing.assert_array_equal(tasks, jcode.compute_all_tasks(jX, jY))
    exact = a.astype(np.int64).T @ b.astype(np.int64)
    for ids in ([0, 1, 2, 3], [2, 3, 4, 5], [5, 1, 4, 0]):
        got = tcode.decode(ids, tasks[ids])
        np.testing.assert_array_equal(got, jcode.decode(ids, tasks[ids]))
        np.testing.assert_array_equal(got, exact)


def test_modmatmul_bit_exact(rng):
    p = tc.MERSENNE_P
    x = rng.integers(0, p, size=(8, 5), dtype=np.uint64)
    y = rng.integers(0, p, size=(8, 4), dtype=np.uint64)
    np.testing.assert_array_equal(tc.modmatmul(x, y), jc.modmatmul(x, y))
    inv_t = tc._vandermonde_inv_mod([1, 2, 3, 5], p)
    inv_j = jc._vandermonde_inv_mod([1, 2, 3, 5], p)
    assert (inv_t == inv_j).all()


@pytest.mark.parametrize("k,levels,omega", [(4, 3, 1.5), (4, 2, 1.25),
                                            (4, 3, 1.0), (9, 4, 1.3),
                                            (2, 5, 2.0)])
def test_hierarchical_level_lengths_equal(k, levels, omega):
    n1, n2 = (2, k // 2) if k % 2 == 0 else (3, 3)
    th = tc.HierarchicalCode(n1=n1, n2=n2, levels=levels, omega=omega)
    jh = jc.HierarchicalCode(n1=n1, n2=n2, levels=levels, omega=omega)
    assert th.level_lengths == jh.level_lengths
    assert th.num_tasks == jh.num_tasks
    for l in range(levels):
        assert th.level_code(l).num_tasks == jh.level_code(l).num_tasks
    assert (tc._hier_level_lengths(k, levels, levels * th.base_tasks)
            == jc._hier_level_lengths(k, levels, levels * jh.base_tasks))
    with pytest.raises(ValueError):
        tc._hier_level_lengths(4, 3, 11)


def test_decode_plan_cache_counts_match(rng):
    """The LRU behaves identically: the same decode sequence gives the
    same hit/miss counts in both packages."""
    seq = [[0, 1, 2, 3], [3, 2, 1, 0], [1, 2, 3, 4], [0, 1, 2, 3]]
    res = rng.normal(size=(4, 3, 3))
    infos = []
    for mod in (tc, jc):
        plan = mod.DecodePlan(mod._eval_points(6, "float"), 4, cache_size=2)
        outs = [plan.solve(ids, res) for ids in seq]
        infos.append((plan.cache_info(), outs))
    assert infos[0][0] == infos[1][0]
    for o_t, o_j in zip(infos[0][1], infos[1][1]):
        np.testing.assert_array_equal(o_t, o_j)


def test_mds_code_float64_on_tensor_device(rng):
    code = tc.MDSCode(k=3, n=5)
    shards = torch.from_numpy(rng.normal(size=(3, 4, 2)))
    cw = code.encode(shards)
    assert cw.dtype == torch.float64 and cw.shape == (5, 4, 2)
    with jax.enable_x64(True):
        jcw = np.asarray(jc.MDSCode(k=3, n=5).encode(shards.numpy()))
    np.testing.assert_allclose(cw.numpy(), jcw, rtol=1e-12)
    for ids in ([0, 1, 2], [4, 1, 3]):
        got = code.decode(ids, cw[ids])
        np.testing.assert_allclose(got.numpy(), shards.numpy(), rtol=1e-9,
                                   atol=1e-12)
        host = code.decode(ids, cw.numpy()[ids])
        np.testing.assert_allclose(host.numpy(), shards.numpy(), rtol=1e-9,
                                   atol=1e-12)
    assert code.generator(device="cpu").shape == (5, 3)
    with pytest.raises(ValueError):
        tc.MDSCode(k=4, n=3)
