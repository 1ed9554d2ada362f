"""Port parity: ``repro_torch.core.layering`` against ``repro.core.layering``.

The same seeded NumPy inputs go through both packages on the CPU.  The
bookkeeping, digit planes, quantization and oracles must agree exactly.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import layering as jl  # noqa: E402
from repro_torch.core import layering as tl  # noqa: E402

CASES = [(2, 7), (3, 5), (4, 4), (1, 7), (2, 8), (5, 6)]


@pytest.mark.parametrize("m", [1, 2, 3, 4, 5])
def test_bookkeeping_equal(m):
    assert tl.num_layers(m) == jl.num_layers(m)
    assert tl.minijobs_per_layer(m) == jl.minijobs_per_layer(m)
    assert tl.cumulative_minijobs(m) == jl.cumulative_minijobs(m)
    assert tl.all_minijobs_msb_first(m) == jl.all_minijobs_msb_first(m)
    for l in range(tl.num_layers(m)):
        assert tl.layer_minijobs(m, l) == jl.layer_minijobs(m, l)
        for d in (4, 7):
            assert (tl.resolution_error_bound(m, d, 64, l)
                    == jl.resolution_error_bound(m, d, 64, l))


def test_bookkeeping_errors_equal():
    for fn, args in ((tl.num_layers, (0,)), (tl.layer_minijobs, (2, 3))):
        with pytest.raises(ValueError):
            fn(*args)
    with pytest.raises(ValueError):
        tl.decompose(torch.zeros(3, dtype=torch.int32), 0, 4)
    with pytest.raises(TypeError):
        tl.decompose(torch.zeros(3), 2, 4)


@pytest.mark.parametrize("m,d", CASES)
def test_decompose_reconstruct_bit_equal(rng, m, d):
    """Signed inputs inside ``m*d`` bits, plus int32 values outside them
    (the top chunk keeps the overflow bits in both packages)."""
    hi = min(1 << (m * d - 1), 1 << 30)
    x = rng.integers(-hi, hi, size=(17, 9)).astype(np.int32)
    x[0, :4] = [np.iinfo(np.int32).min, np.iinfo(np.int32).max, -1, 0]
    want = np.asarray(jl.decompose(jnp.asarray(x), m, d))
    got = tl.decompose(torch.from_numpy(x), m, d)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    back = tl.reconstruct(got, d)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jl.reconstruct(jnp.asarray(want), d)))
    np.testing.assert_array_equal(back.numpy(), x)


def test_decompose_keeps_int64_and_narrow_ints_widen(rng):
    x = rng.integers(-(1 << 40), 1 << 40, size=(5, 5))
    got = tl.decompose(torch.from_numpy(x), 3, 15)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), tl._np_decompose(x, 3, 15))
    small = tl.decompose(torch.tensor([-3, 5], dtype=torch.int8), 2, 2)
    assert small.dtype == torch.int32
    np.testing.assert_array_equal(
        small.numpy(), np.asarray(jl.decompose(
            jnp.asarray([-3, 5], jnp.int8), 2, 2)))


@pytest.mark.parametrize("bits", [8, 14, 16, 24])
def test_quantize_equal_q_and_bit_equal_scale(rng, bits):
    x = (rng.normal(size=(33, 7)) * 3.7).astype(np.float32)
    jq, js = jl.quantize(jnp.asarray(x), bits)
    tq, ts = tl.quantize(torch.from_numpy(x), bits)
    assert tq.dtype == torch.int32 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert ts.numpy().tobytes() == np.asarray(js, np.float32).tobytes()
    np.testing.assert_array_equal(
        tl.dequantize(tq, ts).numpy(),
        np.asarray(jl.dequantize(jq, js)))


@pytest.mark.parametrize("m,d", CASES[:4])
def test_reference_oracle_equal(rng, m, d):
    hi = 1 << (m * d - 1)
    a = rng.integers(-hi, hi, size=(24, 6))
    b = rng.integers(-hi, hi, size=(24, 5))
    got = tl.layered_matmul_reference(a, b, m=m, d=d)
    np.testing.assert_array_equal(
        got, jl.layered_matmul_reference(a, b, m=m, d=d))
    np.testing.assert_array_equal(got[-1], a.T @ b)
    np.testing.assert_array_equal(tl._np_decompose(a, m, d),
                                  jl._np_decompose(a, m, d))


@pytest.mark.parametrize("K,top", [(64, 1 << 23), (64, 1 << 24),
                                   (1 << 20, 1 << 16), (1 << 21, 1 << 16)],
                         ids=("short-float64", "short-int64",
                              "long-float64", "long-int64"))
def test_plane_product_exact_on_both_sides_of_the_bound(rng, K, top):
    """The oracle's float64 BLAS path (every partial sum below 2**53) and
    its int64 path give the int64 product on either side of the bound:
    K * top**2 is 2**52 (float64) and 2**54 (int64) for the short pair,
    2**52 and 2**53 for the long one."""
    x = rng.integers(-top, top + 1, size=(K, 3))
    y = rng.integers(-top, top + 1, size=(K, 2))
    x[0, 0], y[0, 0] = top, top         # the bound's own magnitudes
    got = tl._np_plane_product(x, y)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, x.T @ y)


@pytest.mark.parametrize("m,d", [(2, 8), (3, 5), (1, 7)])
def test_layered_matmul_torch_matches_jnp(rng, m, d):
    """Both fuse in float32, whose rounding depends on the summation
    order XLA picks, so the tolerance is test_kernels.py's fused rtol."""
    hi = 1 << (m * d - 1)
    a = rng.integers(-hi, hi, size=(48, 8)).astype(np.int32)
    b = rng.integers(-hi, hi, size=(48, 12)).astype(np.int32)
    want = np.asarray(jl.layered_matmul_jnp(jnp.asarray(a), jnp.asarray(b),
                                            m=m, d=d))
    got = tl.layered_matmul_torch(torch.from_numpy(a), torch.from_numpy(b),
                                  m=m, d=d)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    np.testing.assert_allclose(got.numpy(),
                               tl.layered_matmul_reference(a, b, m=m, d=d),
                               rtol=1e-6)
