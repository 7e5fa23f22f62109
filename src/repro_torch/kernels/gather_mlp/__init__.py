from .ops import gather_mlp
from .ref import gather_mlp_ref

__all__ = ["gather_mlp", "gather_mlp_ref"]
