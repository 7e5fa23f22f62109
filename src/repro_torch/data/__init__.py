"""Synthetic data (the port's copy of ``repro.data``)."""
