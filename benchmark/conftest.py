"""pytest settings of the benchmark's own tests (python -m pytest benchmark/tests)."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips inside the test when there is none")
