"""Optimizers and LR schedules (the port of ``repro.optim``): pure
functions of nested-dict params and state, updating in place."""
