"""The JAX package's ``benchmarks/accuracy.py`` (PCN training and the
paper's Fig. 20 run) and its four ``examples/``, each runnable as
``python -m repro_torch.examples.<name>`` (the GPU unless ``--device
cpu``)."""
