"""Port parity: ``LayeredCodedMatmul`` (paper §III end to end).

The JAX class encodes float mode in float32 unless x64 is on, so float
mode is compared with x64 enabled for the duration of the JAX call; the
port encodes in float64 on its device either way.  GF(p) mode is host
integer arithmetic in both and must be bit-exact.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from repro.core.layered_matmul import \
    LayeredCodedMatmul as JaxLCM  # noqa: E402
from repro_torch.core.layered_matmul import \
    LayeredCodedMatmul as TorchLCM  # noqa: E402


def _operands(rng, kind):
    if kind == "float":
        return (rng.normal(size=(32, 8)).astype(np.float32),
                rng.normal(size=(32, 12)).astype(np.float32))
    return (rng.integers(-(1 << 13), 1 << 13, size=(32, 8)),
            rng.integers(-(1 << 13), 1 << 13, size=(32, 12)))


@pytest.mark.parametrize("kind", ["float", "int"])
@pytest.mark.parametrize("erasures,seed", [((), None), ((0, 3), None),
                                           ((), 7)])
def test_float_mode_matches_jax(rng, kind, erasures, seed):
    a, b = _operands(rng, kind)
    kw = dict(m=2, d=8, n1=2, n2=2, omega=1.5)
    got, scale = TorchLCM(device="cpu", **kw).run(a, b, erasures=erasures,
                                                  seed=seed)
    with jax.enable_x64(True):
        want, jscale = JaxLCM(**kw).run(a, b, erasures=erasures, seed=seed)
    assert float(scale) == float(jscale)
    assert got.shape == (3, 8, 12)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-9,
                               atol=1e-9 * np.abs(want).max())


@pytest.mark.parametrize("kind", ["float", "int"])
def test_gfp_mode_bit_exact_with_jax(rng, kind):
    a, b = _operands(rng, kind)
    kw = dict(m=2, d=8, n1=2, n2=2, omega=1.5, mode="gfp")
    got, scale = TorchLCM(device="cpu", **kw).run(a, b, seed=11)
    want, jscale = JaxLCM(**kw).run(a, b, seed=11)
    assert float(scale) == float(jscale)
    np.testing.assert_array_equal(got, np.asarray(want))
    if kind == "int":
        np.testing.assert_array_equal(got[-1], a.T @ b)


def test_resolutions_refine_and_too_many_erasures_raise(rng):
    a, b = _operands(rng, "int")
    lcm = TorchLCM(device="cpu", m=3, d=6, n1=2, n2=2, omega=1.25)
    res, _ = lcm.run(a, b, erasures=(4,))
    exact = a.T @ b
    errs = [np.abs(r - exact).max() for r in res]
    assert all(x >= y for x, y in zip(errs, errs[1:]))
    assert errs[-1] <= 1e-6 * np.abs(exact).max()
    with pytest.raises(ValueError):
        lcm.run(a, b, erasures=(0, 1))
