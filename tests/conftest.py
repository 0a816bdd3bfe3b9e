"""Shared fixtures. NOTE: no XLA_FLAGS here — tests see the single real CPU
device; multi-device tests spawn subprocesses with their own flags."""
import jax
import pytest


@pytest.fixture(scope="session")
def rng():
    return jax.random.PRNGKey(0)


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running integration test")
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips without one")
