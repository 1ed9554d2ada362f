"""Shared fixtures.  NOTE: no XLA_FLAGS here — tests see 1 CPU device;
only launch/dryrun.py forces 512 host devices (per the brief)."""

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA Hopper GPU and nvcc (the PyTorch "
        "port's kernels); skips elsewhere")
