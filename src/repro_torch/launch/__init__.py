"""Entry points: the fault-tolerant training launcher."""
