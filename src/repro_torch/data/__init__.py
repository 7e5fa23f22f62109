"""Synthetic data and the token stream (the port's copy of
``repro.data``)."""
