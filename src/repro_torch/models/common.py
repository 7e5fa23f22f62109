"""Shared PCN model machinery: the spec types, re-exported from
:mod:`repro_torch.engine.spec` (the port's copy of
``repro.models.common``)."""
from __future__ import annotations

from ..engine.spec import BlockSpec, PCNSpec, block_in_dim  # noqa: F401
