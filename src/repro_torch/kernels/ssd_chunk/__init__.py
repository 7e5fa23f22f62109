from .ops import ssd_chunk
from .ref import ssd_chunk_ref

__all__ = ["ssd_chunk", "ssd_chunk_ref"]
