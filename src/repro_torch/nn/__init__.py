"""NN primitives of the LM substrate (the port of ``repro.nn``)."""
