"""Carry the JAX package's LM params and decode caches across, as numpy
arrays: nested dicts and lists of arrays become the same nesting of
tensors on ``device`` (default: the GPU), each in its own dtype
(bfloat16 stays bfloat16, int8 codes int8)."""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device


def _tensor(a, device) -> torch.Tensor:
    a = np.array(a, order="C")           # a writable copy
    if a.dtype.name == "bfloat16":       # ml_dtypes' bfloat16: same bits
        return torch.from_numpy(a.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _tree(tree, device: torch.device):
    """dicts / lists / tuples of arrays -> the same of tensors."""
    if isinstance(tree, dict):
        return {k: _tree(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree(v, device) for v in tree)
    return _tensor(tree, device)


def lm_params_from_numpy(tree, device=None) -> dict:
    """JAX ``model_zoo.init`` params (as numpy arrays) -> the port's."""
    return _tree(tree, resolve_device(device))


def lm_cache_from_numpy(tree, device=None) -> list:
    """JAX ``model_zoo.make_cache`` caches (as numpy arrays) -> the
    port's, whose attention caches a decode step then updates in
    place."""
    return _tree(tree, resolve_device(device))
