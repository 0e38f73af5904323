"""Fixtures of the benchmark's CPU tests."""

import pytest

from tinycell import TINY_LIMITS, TINY_TRAFFIC, make_root, tiny_config


@pytest.fixture
def tiny_root(tmp_path):
    return make_root(tmp_path, tiny_config(), TINY_TRAFFIC, TINY_LIMITS)
