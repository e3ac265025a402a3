"""Synthetic data for the port's benchmarks and tests."""
