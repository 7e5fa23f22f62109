"""The port of ``repro.dist``: the scale-out substrate over
``torch.distributed``.

Submodules:
  sharding  — logical-axis sharding rules (dp/fsdp/tp/sp), the
              ``use_mesh`` context, param/batch/cache shardings as DTensor
              placements, and the seams where model code meets DTensors.
  pipeline  — ``pipeline_apply``: a GPipe microbatch schedule over a mesh
              axis (point-to-point sends).
  compress  — gradient codecs with error feedback (int8 quantization,
              top-k sparsification).

Importing them imports no ``torch.distributed``: that happens when a mesh
is built or a DTensor is made.
"""
from . import compress, pipeline, sharding  # noqa: F401
