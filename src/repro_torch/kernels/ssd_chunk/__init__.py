from .ops import SsdChunkFn, ssd_chunk, ssd_chunk_backward
from .ref import ssd_chunk_bwd_ref, ssd_chunk_ref

__all__ = ["SsdChunkFn", "ssd_chunk", "ssd_chunk_backward", "ssd_chunk_ref",
           "ssd_chunk_bwd_ref"]
