"""TPC-H Q12-Q22 at ``tiny`` with the device cache on, cold then warm,
through both Sessions (Q1-Q11 and the test of the cached tensors are in
test_torch_tpch_cached.py)."""
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_torch_tpch_cached import PROPS, check_cached_query  # noqa: E402

from trino_tpu.client.session import Session as JaxSession  # noqa: E402
from trino_tpu_torch import Session as TorchSession  # noqa: E402


@pytest.fixture(scope="module")
def sessions():
    return JaxSession(properties=dict(PROPS)), TorchSession(dict(PROPS), device="cpu")


@pytest.mark.parametrize("q", range(12, 23))
def test_tpch_tiny_cached_cold_warm_more(sessions, q):
    check_cached_query(*sessions, q)
