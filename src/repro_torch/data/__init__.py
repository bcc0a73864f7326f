"""Deterministic synthetic token streams (`pipeline`)."""
