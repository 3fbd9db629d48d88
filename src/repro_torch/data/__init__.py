"""Deterministic synthetic data (the reference's data/)."""
