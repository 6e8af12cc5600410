"""The lock-discipline analyzer of tools/lint over the port.

tools/lint/lock_discipline.py walks every class's ``with self._lock``
regions and flags nested acquisitions in inverted order, re-entry of a
non-reentrant lock, blocking calls under a lock and ledger appends under a
lock (the flow ledger's ``record_transfer`` and ``record_stall`` sites
included, which take the ledger's own lock). Its ``analyze`` runs here,
through ``analyze_file`` with the files' suppression comments, over every
file of trino_tpu_torch/, one case a file, and finds nothing.
"""
import os

import pytest

from tools.lint import analyze_file
from tools.lint import lock_discipline

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "trino_tpu_torch")
FILES = sorted(os.path.relpath(os.path.join(d, f), ROOT)
               for d, _dirs, files in os.walk(ROOT) for f in files if f.endswith(".py"))


def test_the_port_has_python_files():
    assert len(FILES) > 100 and "server/coordinator.py" in FILES


@pytest.mark.parametrize("path", FILES)
def test_no_lock_discipline_violation(path):
    found = analyze_file(os.path.join(ROOT, path), lock_discipline.analyze)
    assert [v.format() for v in found] == []
