"""Parallel execution of the port: the device mesh and its collectives
(``mesh``), the hash and range exchanges over it (``exchange``, with the
host half of the adaptive skew salting) and the SPMD tier that runs one
query on every rank of a mesh (``spmd``)."""
