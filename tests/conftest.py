"""Every test under ``tests/`` runs under a time limit (``time_limits.py``),
so a test that hangs fails instead of holding its worker until the run is
cut."""
import pytest

from time_limits import limit_for, time_limit


@pytest.hookimpl(wrapper=True)
def pytest_runtest_call(item):
    """Run the test's call phase under its limit. A test whose code caught
    the limit's raise and then finished fails here, once."""
    limit = limit_for(item)
    with time_limit(limit) as fired:
        result = yield
    if fired:
        pytest.fail(f"the time limit of {limit:g} s fired during the test")
    return result
