"""Synthetic data generators (plain numpy)."""
