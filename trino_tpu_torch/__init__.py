"""trino_tpu_torch: the PyTorch/CUDA port of the trino_tpu SQL engine.

The JAX package (``trino_tpu``) stays the reference. This package imports
neither JAX nor ``trino_tpu``: the host-side modules (types, parser,
analyzer, planner, connectors, session properties) are copies of the
reference's, and the device side (``data/page.py``, ``ops/``, ``exec/``)
is PyTorch, with the reference's one Pallas kernel rewritten for Hopper in
CUDA C++ (``ops/merge.py`` + ``csrc/merge_unique_sorted.cu``).

Every dtype is given explicitly: the reference runs JAX with x64 enabled,
so a bare Python float is float64 there and float32 in torch.
"""

__version__ = "0.1.0"

from trino_tpu_torch.client.session import Session  # noqa: E402,F401
