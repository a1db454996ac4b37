"""The benchmark's own tests: ``python -m pytest benchmark/tests -q``. Tests
marked ``cuda`` decide inside the test whether there is a card."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips where there is none")
