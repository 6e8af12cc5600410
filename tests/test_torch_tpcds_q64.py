"""TPC-DS q64 and its wide variant (tests/tpcds_sql.py) through both
Sessions on the CPU at ``tiny``: the 18-relation join tree, rows with each
tie group of the partial ORDER BY compared as a multiset, and join tiers."""
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_torch_sql_both import BothSessions  # noqa: E402
from test_torch_tpcds import check_tiny, props  # noqa: E402


@pytest.fixture(scope="module")
def both():
    return BothSessions(props("tiny"))


@pytest.mark.parametrize("name", ["q64", "q64_wide"])
def test_query_tiny_equals_reference(both, name):
    check_tiny(both, name)
