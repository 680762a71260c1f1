import os

# Tests run on the single real CPU device; ONLY dryrun.py gets 512 fake
# devices.  Multi-device tests spawn subprocesses with their own XLA_FLAGS.
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: F401  -- imported early so the platform pin above sticks
import numpy as np
import pytest

# Hypothesis profiles (optional dependency — see tests/_hyp.py):
# "default" keeps CI's per-push runs cheap; "deep" is the scheduled
# nightly sweep (.github/workflows/ci.yml sets HYPOTHESIS_PROFILE=deep).
# Tests that pin max_examples via @settings(...) keep their own budget.
try:
    from hypothesis import HealthCheck, settings as _hyp_settings

    _hyp_settings.register_profile("default", max_examples=50,
                                   deadline=None)
    _hyp_settings.register_profile(
        "deep", max_examples=1000, deadline=None,
        suppress_health_check=[HealthCheck.too_slow])
    _hyp_settings.load_profile(os.environ.get("HYPOTHESIS_PROFILE",
                                              "default"))
except ImportError:
    pass


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running integration test")
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skips without one")
