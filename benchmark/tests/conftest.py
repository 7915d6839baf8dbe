"""Settings of the benchmark's own tests: the ``card`` marker for a test
that needs an NVIDIA card (it skips, deciding inside the test, without
one)."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card; skips without one")
