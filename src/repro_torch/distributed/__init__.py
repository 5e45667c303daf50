"""Mesh plumbing of the port: partition rules and DTensor placement
(``sharding``) and the GPipe schedule (``pipeline``)."""
