"""Synthetic, deterministic training data."""
