"""Async, atomic, integrity-checked checkpoints of a train state."""
