"""The port of ``repro.dist``: gradient compression only.  Sharding and
pipeline parallelism (``dist/sharding.py``, ``dist/pipeline.py``) come
with the multi-device slice (ROADMAP queue 1 item 8)."""
from . import compress  # noqa: F401
