"""Shared fixtures. NOTE: no XLA_FLAGS here — smoke tests and benches see
the 1 real CPU device; only launch/dryrun.py (a subprocess in tests) forces
512 placeholder devices."""
import os
import sys

import numpy as np
import pytest

try:
    import hypothesis  # noqa: F401
except ImportError:  # container image has no hypothesis; use the stub
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "_stubs"))


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: multi-minute compile-heavy tests (dry-run integration); "
        "deselect with -m 'not slow'")
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU and nvcc (the port's CUDA kernels); "
        "skips without a card")


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def random_undirected_graph(n: int, p: float, seed: int = 0):
    """Symmetric edge list (both directions), no self loops."""
    r = np.random.default_rng(seed)
    a = r.random((n, n)) < p
    a = np.triu(a, 1)
    a = a | a.T
    src, dst = np.nonzero(a)
    return src.astype(np.int64), dst.astype(np.int64), a


def brute_triangle_count(adj: np.ndarray) -> int:
    """Count undirected triangles by trace(A^3)/6."""
    a = adj.astype(np.int64)
    return int(np.trace(a @ a @ a) // 6)
