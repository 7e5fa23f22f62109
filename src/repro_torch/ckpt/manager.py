"""Checkpoint manager: atomic, step-tagged, restart-safe (the port of
``repro.ckpt.manager``), in the JAX package's on-disk layout, so that a
checkpoint written by either package restores in the other.

Layout (one directory per step):
    <root>/step_000000120/
        meta.json       step, data-pipeline state, leaf names and dtypes
        host_000.npz    the leaves of {"params", "opt"}, named by their
                        "/"-joined paths in jax.tree_util's order
        COMMIT          written last; a directory without it is ignored

A step is published by ``os.replace`` of its ``.tmp`` directory.  npz
holds no bfloat16: such leaves are stored as uint16 views with their
dtype in ``leaf_dtypes``.  Contract of ``launch/train.py``: save every N
steps and on SIGTERM; ``restore()`` returns (step, params, opt_state,
data_state) or None; keep the newest K, deleting older ones only after
the new COMMIT exists.

Under a mesh (DTensor leaves) the ranks gather one leaf at a time, rank
0 copies it to host memory and the others drop it, so a device holds one
whole leaf at most; rank 0 writes them, so the layout does not depend on
the mesh.  ``restore(..., shardings=)`` lays the leaves out on the
current mesh, which need not be the one that wrote them.
"""
from __future__ import annotations

import json
import os
import shutil
import time

import numpy as np
import torch

from .. import tree
from ..dist.sharding import is_dtensor

# npz can't hold these: stored as unsigned views of their width
_VIEW = {"bfloat16": (np.uint16, np.int16, torch.bfloat16),
         "float8_e4m3fn": (np.uint8, np.int8, torch.float8_e4m3fn)}
_NAME = {v[2]: k for k, v in _VIEW.items()}


def _to_numpy(t: torch.Tensor) -> tuple[np.ndarray, str]:
    """(array, logical dtype name) of a tensor, a view where npz needs
    one."""
    t = t.detach().cpu().contiguous()
    name = _NAME.get(t.dtype)
    if name is None:
        a = t.numpy()
        return a, str(a.dtype)
    view, signed, _ = _VIEW[name]
    return t.view(getattr(torch, np.dtype(signed).name)).numpy().view(
        view), name


def _to_tensor(a: np.ndarray, name: str) -> torch.Tensor:
    if name in _VIEW:
        _, signed, dtype = _VIEW[name]
        return torch.from_numpy(np.array(a, order="C").view(signed)).view(
            dtype)
    return torch.from_numpy(np.array(a, order="C"))


class CheckpointManager:
    def __init__(self, root: str, keep: int = 3):
        self.root = root
        self.keep = keep
        os.makedirs(root, exist_ok=True)

    # -- save ---------------------------------------------------------------

    def save(self, step: int, params, opt_state, data_state: dict,
             extra: dict | None = None) -> str:
        state = {"params": params, "opt": opt_state}
        names, leaves = tree.paths(state), tree.leaves(state)
        if not any(is_dtensor(t) for t in leaves):
            return self._write(step, names, map(_to_numpy, leaves),
                               data_state, extra)
        # a collective: the ranks gather leaf by leaf, rank 0 writes
        import torch.distributed as dist
        lead = dist.get_rank() == 0
        host = []
        for t in leaves:
            whole = t.full_tensor() if is_dtensor(t) else t
            if lead:
                host.append(_to_numpy(whole))
            del whole
        if lead:
            self._write(step, names, host, data_state, extra)
        dist.barrier()
        return os.path.join(self.root, f"step_{step:09d}")

    def _write(self, step, names, host, data_state, extra) -> str:
        """Publish ``host``, the leaves as ``_to_numpy`` pairs."""
        d = os.path.join(self.root, f"step_{step:09d}")
        tmp = d + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)

        arrays, dtypes = {}, {}
        for name, (arr, dtype) in zip(names, host):
            arrays[name], dtypes[name] = arr, dtype
        np.savez(os.path.join(tmp, "host_000.npz"), **arrays)

        meta = {
            "step": step,
            "time": time.time(),
            "data_state": data_state,
            "n_devices": 1,
            "leaf_names": names,
            "leaf_dtypes": dtypes,
            "extra": extra or {},
        }
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        with open(os.path.join(tmp, "COMMIT"), "w") as f:
            f.write("ok")
        os.replace(tmp, d)      # atomic publish
        self._gc()
        return d

    # -- restore ------------------------------------------------------------

    def _committed(self) -> list:
        return sorted(
            int(n.split("_")[1]) for n in os.listdir(self.root)
            if n.startswith("step_") and not n.endswith(".tmp")
            and os.path.exists(os.path.join(self.root, n, "COMMIT")))

    def latest_step(self) -> int | None:
        steps = self._committed()
        return steps[-1] if steps else None

    def restore(self, params_like, opt_like, shardings=None):
        """-> (step, params, opt_state, data_state) or None.
        ``params_like`` / ``opt_like``: trees with the target structure;
        each leaf comes back in its like's shape (checked), dtype and
        device.  ``shardings``: ``{"params": ..., "opt": ...}`` trees of
        ``dist.sharding.Sharding`` for the current mesh, each leaf then a
        DTensor of its placements."""
        step = self.latest_step()
        if step is None:
            return None
        d = os.path.join(self.root, f"step_{step:09d}")
        with open(os.path.join(d, "meta.json")) as f:
            meta = json.load(f)
        like = {"params": params_like, "opt": opt_like}
        dtypes = meta.get("leaf_dtypes", {})
        sh_leaves = ([None] * len(tree.leaves(like)) if shardings is None
                     else tree.flatten_up_to(like, shardings))
        out = []
        with np.load(os.path.join(d, "host_000.npz")) as data:
            for name, ref, sh in zip(tree.paths(like), tree.leaves(like),
                                     sh_leaves):
                arr = data[name]
                t = _to_tensor(arr, dtypes.get(name, str(arr.dtype)))
                if tuple(t.shape) != tuple(ref.shape):
                    raise ValueError(
                        f"checkpoint leaf {name}: shape {tuple(t.shape)} "
                        f"!= expected {tuple(ref.shape)}")
                t = t.to(device=ref.device, dtype=ref.dtype)
                out.append(t if sh is None else sh.distribute(t))
        restored = tree.unflatten(like, out)
        return (meta["step"], restored["params"], restored["opt"],
                meta["data_state"])

    def _gc(self):
        for s in self._committed()[:-self.keep]:
            shutil.rmtree(os.path.join(self.root, f"step_{s:09d}"),
                          ignore_errors=True)
