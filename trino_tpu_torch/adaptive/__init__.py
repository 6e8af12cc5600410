"""Adaptive execution of the port: capacity-hint reseeding from staged
truth for the compiled tier (``reseed.py``), the port of
trino_tpu/adaptive/reseed.py for one device. The re-planner and the
runtime-stats provider of the JAX package are not ported."""
