"""L-PCN in PyTorch for NVIDIA Hopper: the port of ``repro`` (JAX/TPU).

Module names mirror the JAX package (``core``, ``engine``, ``kernels``,
``models``) so each counterpart is easy to find.  Entry points run on the
CUDA device unless the caller passes ``device="cpu"``; the two FC
dataflows run in hand-written CUDA kernels (``kernels/``, sources in
``csrc/``), with a plain PyTorch version beside each.
"""
