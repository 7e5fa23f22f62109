"""Containers of the engine API: :class:`PCNParams` (all weights of one
PCN), :class:`Batch` (padded clouds with per-cloud keys and valid counts)
and the converters that carry JAX weights and structures across as numpy
arrays."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import random
from ..core.hub_schedule import Schedule
from ..core.islandize import Islands
from ..core.mlp import MLP, Dense
from ..core.pipeline import BlockStructure
from ..device import resolve_device


@dataclass(frozen=True)
class PCNParams:
    """blocks: one MLP per building block; head: classifier MLP;
    global_mlp: final global-SA MLP (cls; None otherwise); stem / extras:
    the PointNeXt / PointVector branches (None / empty for PointNet++)."""
    blocks: tuple
    head: MLP
    global_mlp: MLP | None = None
    stem: MLP | None = None
    extras: tuple = ()


def from_legacy(params) -> PCNParams:
    """A legacy per-model param dict as :class:`PCNParams`: the layouts
    {"blocks", "global", "head"}, {"stem", "blocks", "invres", "head"}
    and {"stem", "blocks", "vector", "head"}; a PCNParams passes through
    unchanged."""
    if isinstance(params, PCNParams):
        return params
    extras = params.get("invres") or params.get("vector") or ()
    return PCNParams(blocks=tuple(params["blocks"]), head=params["head"],
                     global_mlp=params.get("global"),
                     stem=params.get("stem"), extras=tuple(extras))


def to_legacy(params: PCNParams, arch: str) -> dict:
    """:class:`PCNParams` in the legacy dict layout of ``arch``."""
    if arch == "pointnext":
        return {"stem": params.stem, "blocks": list(params.blocks),
                "invres": list(params.extras), "head": params.head}
    if arch == "pointvector":
        return {"stem": params.stem, "blocks": list(params.blocks),
                "vector": list(params.extras), "head": params.head}
    return {"blocks": list(params.blocks), "global": params.global_mlp,
            "head": params.head}


def _field(obj, name, default=None):
    if isinstance(obj, dict):
        return obj.get(name, default)
    return getattr(obj, name, default)


def _tensor(a, device, dtype=None) -> torch.Tensor:
    t = torch.from_numpy(np.array(a, order="C"))
    if dtype is None:
        dtype = {torch.bool: torch.bool, torch.float64: torch.float32,
                 torch.float32: torch.float32}.get(t.dtype, torch.int64)
    return t.to(device=device, dtype=dtype).contiguous()


def _mlp_from_numpy(m, device) -> MLP | None:
    if m is None:
        return None
    layers = [Dense(w=_tensor(_field(l, "w"), device, torch.float32),
                    b=_tensor(_field(l, "b"), device, torch.float32))
              for l in _field(m, "layers")]
    return MLP(layers=layers, activation=_field(m, "activation",
                                                "per_layer"))


def params_from_numpy(tree, device=None) -> PCNParams:
    """Carry weights across from the JAX package: ``tree`` is a
    ``PCNParams`` whose leaves are numpy arrays (or the same layout as
    nested dicts: blocks / head / global_mlp / stem / extras, each MLP
    with ``layers`` of ``w`` (in, out) and ``b`` and an ``activation``)."""
    device = resolve_device(device)
    return PCNParams(
        blocks=tuple(_mlp_from_numpy(m, device)
                     for m in _field(tree, "blocks")),
        head=_mlp_from_numpy(_field(tree, "head"), device),
        global_mlp=_mlp_from_numpy(_field(tree, "global_mlp"), device),
        stem=_mlp_from_numpy(_field(tree, "stem"), device),
        extras=tuple(_mlp_from_numpy(m, device)
                     for m in (_field(tree, "extras") or ())))


def structure_from_numpy(st, device=None) -> BlockStructure:
    """A stacked JAX ``BlockStructure`` (numpy leaves, leading (B,) axis)
    as the port's :class:`BlockStructure`, for FC-stage tests on
    structures built by the JAX package."""
    device = resolve_device(device)

    def conv(obj, cls, names):
        if obj is None:
            return None
        # the hub_reuse kernel reads its slots as int32
        return cls(**{n: _tensor(_field(obj, n), device,
                                 torch.int32 if n == "reuse_slot" else None)
                      for n in names})

    def opt(a):
        return None if a is None else _tensor(a, device)

    return BlockStructure(
        center_idx=_tensor(_field(st, "center_idx"), device),
        center_xyz=_tensor(_field(st, "center_xyz"), device),
        nbr=_tensor(_field(st, "nbr"), device),
        islands=conv(_field(st, "islands"), Islands,
                     ("members", "hub", "solo", "round_of")),
        schedule=conv(_field(st, "schedule"), Schedule,
                      ("pool_ids", "reuse_slot", "is_first", "subset_valid",
                       "pos_live")),
        center_valid=opt(_field(st, "center_valid")),
        nbr_valid=opt(_field(st, "nbr_valid")))


def validate_cloud(arr, name: str = "xyz", index=None) -> np.ndarray:
    """Host-side payload check: reject non-finite values and non-floating
    dtypes, coerce floating dtypes to float32.  -> float32 numpy array."""
    tag = name if index is None else f"{name}[{index}]"
    a = np.asarray(arr)
    if not np.issubdtype(a.dtype, np.floating):
        raise ValueError(f"{tag} has dtype {a.dtype}, which is not a "
                         f"floating point cloud payload; convert to float32")
    a = a.astype(np.float32, copy=False)
    if not np.isfinite(a).all():
        n_bad = int(np.size(a) - np.isfinite(a).sum())
        rows = np.unique(np.argwhere(~np.isfinite(a))[:, 0])[:4]
        raise ValueError(f"{tag} contains {n_bad} non-finite value(s) "
                         f"(NaN/Inf), e.g. in row(s) {rows.tolist()}")
    return a


def key_words(key, device) -> torch.Tensor:
    """A key (or a stack of keys) as int64 key words on ``device``: None
    is ``PRNGKey(0)``; numpy uint32 key data (a JAX key) is accepted."""
    if key is None:
        key = random.PRNGKey(0)
    if not isinstance(key, torch.Tensor):
        key = torch.from_numpy(np.asarray(key).astype(np.int64))
    return key.to(device=device, dtype=torch.int64)


def _keys(key, b: int, device) -> torch.Tensor:
    """(B, 2) per-cloud keys from one key (split per cloud) or a stack."""
    key = key_words(key, device)
    return random.split(key, b) if key.dim() == 1 else key


@dataclass(frozen=True)
class Batch:
    """A padded batch of point clouds, all on one device.

    xyz:     (B, N, 3) float32; short clouds repeat their last point.
    feats:   (B, N, F) float32 per-point features (xyz for geometry only).
    keys:    (B, 2) int64 — one threefry key per cloud (the two uint32
             words of a JAX key), driving random hub selection.
    n_valid: (B,) int64 — true point count per cloud; rows >= n_valid are
             padding and never sampled, gathered, cached or pooled.
    """
    xyz: torch.Tensor
    feats: torch.Tensor
    keys: torch.Tensor
    n_valid: torch.Tensor

    @property
    def batch_size(self) -> int:
        return self.xyz.shape[0]

    def to(self, device) -> "Batch":
        return Batch(*(t.to(device) for t in (self.xyz, self.feats,
                                              self.keys, self.n_valid)))

    @staticmethod
    def make(xyz, feats=None, key=None, n_valid=None, *,
             validate: bool = False, device=None) -> "Batch":
        """Wrap stacked (B, N, 3) / (B, N, F) clouds.  ``key`` is one key
        (split per cloud) or (B, 2) per-cloud keys; ``device`` defaults to
        the GPU."""
        device = resolve_device(device)
        if validate:
            xyz = validate_cloud(xyz, "xyz")
            if feats is not None:
                feats = validate_cloud(feats, "feats")
        xyz = torch.as_tensor(xyz, dtype=torch.float32, device=device)
        b, n = xyz.shape[:2]
        feats = xyz if feats is None else torch.as_tensor(
            feats, dtype=torch.float32, device=device)
        if n_valid is None:
            n_valid = torch.full((b,), n, dtype=torch.int64, device=device)
        return Batch(xyz=xyz.contiguous(), feats=feats.contiguous(),
                     keys=_keys(key, b, device),
                     n_valid=torch.as_tensor(n_valid, dtype=torch.int64,
                                             device=device))

    @staticmethod
    def from_clouds(clouds, feats=None, key=None, n_pad=None, *,
                    validate: bool = False, device=None) -> "Batch":
        """Stack variable-size clouds into one padded batch: each cloud is
        padded to ``n_pad`` rows (default: the longest) by repeating its
        last point, and an empty (0, ·) cloud — a fill row of a partial
        batch — is zero-filled and fully masked (``n_valid == 0``)."""
        clouds = [np.asarray(c) for c in clouds]
        if not clouds:
            raise ValueError("from_clouds needs at least one cloud")
        if validate:
            clouds = [validate_cloud(c, "clouds", i)
                      for i, c in enumerate(clouds)]
            if feats is not None:
                feats = [validate_cloud(f, "feats", i)
                         for i, f in enumerate(feats)]
        longest = max(c.shape[0] for c in clouds)
        n = longest if n_pad is None else int(n_pad)
        if n < longest:
            raise ValueError(f"n_pad={n} is shorter than the longest cloud "
                             f"({longest} points); pick a bucket that fits")
        if n < 1:
            raise ValueError("all clouds are empty; pass n_pad >= 1 to fix "
                             "the padded shape")
        n_valid = np.array([c.shape[0] for c in clouds], np.int64)

        def pad(c):
            if c.shape[0] == n:
                return c
            if c.shape[0] == 0:
                return np.zeros((n,) + c.shape[1:], c.dtype)
            return np.concatenate([c, np.repeat(c[-1:], n - c.shape[0], 0)])

        xyz = np.stack([pad(c) for c in clouds]).astype(np.float32)
        f = None if feats is None else np.stack(
            [pad(np.asarray(x)) for x in feats]).astype(np.float32)
        return Batch.make(xyz, f, key, n_valid, device=device)


def as_batch(batch, device) -> Batch:
    """A Batch moves to ``device``; a (B, N, 3) array becomes a
    geometry-only batch with default keys."""
    if isinstance(batch, Batch):
        return batch if batch.xyz.device == device else batch.to(device)
    if getattr(batch, "ndim", None) != 3:
        raise TypeError(f"expected a Batch or a (B, N, 3) array; got shape "
                        f"{getattr(batch, 'shape', None)}")
    return Batch.make(batch, device=device)
