"""The four window queries of tests/test_torch_tpcds.py (a window over an
aggregate, rank with a top-3 filter, running, offset and lag/lead frames
over every lineitem row, and the ranking family over every order) through
both Sessions on the CPU at ``tiny``: rows within the stated tolerance and
equal join tiers."""
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_torch_sql_both import BothSessions  # noqa: E402
from test_torch_tpcds import ANALYTICS, check_tiny, props  # noqa: E402


@pytest.fixture(scope="module")
def both():
    return BothSessions(props("tiny"))


@pytest.mark.parametrize("name", [n for n in ANALYTICS if n.startswith("w_")])
def test_query_tiny_equals_reference(both, name):
    check_tiny(both, name)
