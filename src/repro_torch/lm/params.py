"""Carry the JAX package's LM params, decode caches and optimizer state
across, as numpy arrays: nested dicts and lists of arrays become the same nesting of
tensors on ``device`` (default: the GPU), each in its own dtype
(bfloat16 stays bfloat16, int8 codes int8)."""
from __future__ import annotations

import numpy as np
import torch

from .. import tree as tree_mod
from ..device import resolve_device


def _tensor(a, device) -> torch.Tensor:
    a = np.array(a, order="C")           # a writable copy
    if a.dtype.name == "bfloat16":       # ml_dtypes' bfloat16: same bits
        return torch.from_numpy(a.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def from_numpy(tree, device=None):
    """A JAX tree as numpy arrays -> the same tree of tensors: its
    ``model_zoo.init`` params, ``model_zoo.make_cache`` caches (whose
    attention caches a decode step then updates in place) or optimizer
    state (``optim.adamw.init_state`` / ``adafactor``'s, with ``"ef"``
    where seeded, the step a 0-d int32), e.g. to start both packages from
    the same mid-training m, v and step."""
    device = resolve_device(device)
    return tree_mod.map(lambda a: _tensor(a, device), tree)
