"""Q12-Q22 of tests/test_torch_cluster_tpch.py: rows against the JAX
Session, join tiers against a JAX cluster."""
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_torch_cluster_tpch import check_query, clusters  # noqa: E402,F401
from tpch_sql import QUERIES  # noqa: E402


@pytest.mark.parametrize("q", [q for q in sorted(QUERIES) if q > 11])
def test_tpch_query_through_the_cluster(clusters, q):  # noqa: F811
    check_query(clusters, q)
