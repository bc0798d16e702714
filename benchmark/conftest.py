"""The benchmark's own pytest settings: its folders on the path and the
``cuda`` marker of the tests that need a card.  Whether there is a card is
decided inside a fixture, never while a module is imported."""

import pathlib
import sys

import pytest

BENCH_DIR = pathlib.Path(__file__).resolve().parent
for p in (str(BENCH_DIR.parent), str(BENCH_DIR)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card (skips without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return torch.device("cuda")


@pytest.fixture
def with_pending(monkeypatch):
    """The manifest with the held-back cells of ``pending/`` in it, for
    the tests that run those cells' code."""
    from harness import loader
    bench = loader.with_pending(loader.manifest())
    monkeypatch.setattr(loader, "manifest", lambda root=loader.ROOT: bench)
    return bench
