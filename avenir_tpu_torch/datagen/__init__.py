"""Synthetic dataset generators (numpy only, seeded)."""
