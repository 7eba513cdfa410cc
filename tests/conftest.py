"""Shared test fixtures.

The persisted plan cache (``repro.core.plan_cache``) defaults to
``~/.cache/repro/plans.json``; every test gets a throwaway path so runs
neither read developer state nor leave artifacts behind.  The env var is
also what spmd subprocess cases inherit, keeping them isolated too.
"""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips where torch finds none")


@pytest.fixture(autouse=True)
def _isolated_plan_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_PLAN_CACHE", str(tmp_path / "plans.json"))
