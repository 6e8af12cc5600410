"""Columnar data plane: device-resident struct-of-arrays batches over torch
tensors (the port of trino_tpu/data)."""
from trino_tpu_torch.data.dictionary import Dictionary
from trino_tpu_torch.data.page import Column, Page

__all__ = ["Dictionary", "Column", "Page"]
