"""Checkpoints (the port of ``repro.ckpt``)."""
