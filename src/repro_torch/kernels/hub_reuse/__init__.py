from .ops import hub_reuse
from .ref import hub_reuse_ref

__all__ = ["hub_reuse", "hub_reuse_ref"]
