"""Fixtures of the benchmark's own tests: a test-sized benchmark root, the
reference's field cache kept under the test's directory, and the card
fixture of the tests marked ``cuda``."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from benchmark.reference import field as ref_field  # noqa: E402
from benchmark.tests import tiny  # noqa: E402


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    """(root, manifest) of the four test-sized cells."""
    root = tmp_path_factory.mktemp("bench") / "benchmark"
    return root, tiny.build(root)


@pytest.fixture(autouse=True)
def field_cache(tmp_path_factory, monkeypatch):
    monkeypatch.setattr(ref_field, "CACHE_DIR",
                        tmp_path_factory.getbasetemp() / "benchcache")


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the hand kernels have no CPU mode")
    return "cuda"
