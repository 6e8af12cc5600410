"""Parallel execution of the port. Only the host half of the adaptive skew
salting is here so far (``exchange.spread_partition_ids``); the SPMD
exchange over several devices is not ported."""
