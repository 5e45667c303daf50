"""Roofline analysis of the port: per-rank FLOPs, bytes and collective wire
bytes counted on meta tensors (``analyze``), and the tables over the dry
run's cells (``report``)."""
