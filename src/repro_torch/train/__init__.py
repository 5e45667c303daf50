"""The training step."""
