from .ops import knn
from .ref import knn_ref

__all__ = ["knn", "knn_ref"]
