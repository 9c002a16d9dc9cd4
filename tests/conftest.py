import pytest


def pytest_configure(config: pytest.Config) -> None:
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA Hopper card (sm_90) and nvcc; skipped on hosts without one",
    )
