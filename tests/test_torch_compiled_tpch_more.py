"""TPC-H Q12-Q22 at ``tiny`` through the port's CompiledQuery against the
JAX package's: the checks of test_torch_compiled_tpch.py (rows of two runs,
the port's eager rows, join tiers, recompiles, staged rows, capacity hints
and in-body dynamic filters), in a second file so the xdist ``loadfile``
workers split the queries."""
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_torch_compiled_tpch import check_query  # noqa: E402


@pytest.mark.parametrize("q", list(range(12, 23)))
def test_compiled_tpch_tiny_equals_reference(q):
    check_query(q)
