"""Geometry and dataflow building blocks of the L-PCN engine."""
