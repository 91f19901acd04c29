import jax
import pytest

# Smoke tests and benches see the single real CPU device; only
# launch/dryrun.py forces 512 host devices (and runs in its own process).


@pytest.fixture(scope="session")
def rng():
    return jax.random.PRNGKey(0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and nvcc; skipped elsewhere")
