"""Dry run of the LM cells on the production meshes (the port of
``repro.launch.dryrun``): one step of each (arch × shape) traced on
shapes alone, with what one device of the mesh would execute, move and
hold.

    PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch A]
        [--shape S] [--multi-pod | --both-meshes] [--out PATH]

The JAX package compiles each cell for 512 forced host devices and reads
XLA's analyses.  Here the world is fake (``launch.mesh.fake_world``: this
process is rank 0 of 256 or 512, whose collectives move nothing) and the
step is the port's own (``lm.steps.make_{train,prefill,decode}_step``)
on ``meta`` DTensors: the params' shapes from ``zoo.init(None, cfg,
"meta")`` laid out by ``param_shardings``, the batch by
``input_specs`` / ``batch_shardings``, the decode cache by
``cache_specs`` / ``cache_shardings``.  A dispatch mode below DTensor
(:class:`DeviceTrace`) sees the ops that rank 0's local shards execute,
after DTensor has turned each global op into local ops and collectives:

* ``hlo_flops_per_chip`` (JAX's key): the flops of rank 0's local
  products (``torch.utils.flop_counter``'s formulas: mm, bmm, addmm, ...;
  elementwise work counts as bytes, not flops).  Replicated work, such as
  MoE routing on every rank, counts on every device, as one device's HLO
  counts it.  No kernel runs on meta tensors, and the kernels' wrappers
  refuse them: the trace routes the LM's kernel calls
  (``nn.attention.flash_attention``, ``nn.ssm.ssd_chunk``) to their plain
  versions (:func:`plain_kernels`), so attention counts its whole score
  matrix, and its scores count as live memory.
* ``hlo_bytes_per_chip``: the bytes of those local ops' inputs and
  outputs, views excepted.  Every op reads and writes HBM here, so this
  is an unfused upper bound of the bytes the card moves.
* ``collective_bytes_per_chip``: by kind (all-reduce, all-gather,
  reduce-scatter, all-to-all), the output bytes of each collective
  DTensor issues, as JAX takes each collective's output shape.
* ``memory``: ``argument_bytes`` (the local shards of params, optimizer
  state and cache, and the batch as the step takes it), ``peak_bytes``
  (the most bytes of local storage alive at once during the step:
  arguments, activations, autograd's saved tensors, temporaries, each
  storage counted from the op that made it until it is freed),
  ``temp_bytes`` (peak less arguments), ``output_bytes`` (the step's
  outputs in fresh storage) and ``alias_bytes`` (outputs in an
  argument's storage: the params and state updated in place, the KV
  caches written in place).  No allocator runs, so fragmentation and
  the caching allocator's rounding are not in it.

``compute_s``, ``memory_s`` and ``collective_s`` divide those by the
H100's data-sheet peaks (``repro_torch.HW``: dense bf16, HBM3, NVLink one
way); ``dominant`` names the largest.  ``lower_s`` is the time to build
the stand-ins and shardings, ``compile_s`` the traced step's.
Training cells are traced with one microbatch (the COST variant, as the
JAX package); on the single-pod mesh the production microbatching, where
it is more than one, is traced again for ``memory``
(``DRYRUN_SKIP_MEM_VARIANT=1`` skips it).
Cells resume from ``--out`` (``ok`` and ``skipped`` ones are kept);
an op the trace cannot run is the cell's ``error``, never an estimate.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback
import weakref

import torch

from .. import HW
from .. import tree
from ..configs import ARCH_IDS, SHAPES, SUBQUADRATIC, get_config
from ..dist import sharding as shd
from ..lm import model_zoo as zoo
from ..lm import steps
from ..optim import adamw
from .mesh import (fake_world, make_mesh, make_production_mesh,
                   release_world)

KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all")
# ops that move no data: views are told by their schema; these besides
_NO_BYTES = {"detach", "alias", "empty", "empty_like", "empty_strided",
             "new_empty", "new_empty_strided", "wait_tensor",
             "_wrap_tensor_autograd", "lift_fresh"}


def collective_kind(name: str) -> str | None:
    """The JAX kind of a collective op's name (``_c10d_functional``'s and
    ``c10d``'s spellings), or None for any other op."""
    n = name.split("::")[-1].replace("_", "")
    for kind in KINDS:
        if kind.replace("-", "") in n:
            return kind
    if "allgather" in n:
        return "all-gather"
    return None


def _tensors(x):
    return [t for t in torch.utils._pytree.tree_leaves(x)
            if isinstance(t, torch.Tensor)]


class DeviceTrace(torch.utils._python_dispatch.TorchDispatchMode):
    """Counts the ops of one device: below DTensor (a DTensor op is handed
    back with ``NotImplemented``, so DTensor runs it as local ops and
    collectives, which this mode then sees) it adds each local op's
    product flops, its bytes, each collective's output bytes by kind, and
    follows every storage an op makes until it is freed (``live``,
    ``peak``)."""

    def __init__(self, arguments=()):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flops = flop_registry
        self.flops = 0
        self.bytes = 0
        self.collectives = {}
        self.live = 0
        self.peak = 0
        self._held = {}
        probe = torch.empty(1, device="meta")
        if probe.untyped_storage() is not probe.untyped_storage():
            raise RuntimeError("DeviceTrace: this torch does not keep one "
                               "Python object a storage; peak memory "
                               "cannot be followed")
        for t in arguments:
            self.hold(t)

    def hold(self, t) -> None:
        """Count ``t``'s storage as live until it is freed."""
        s = t.untyped_storage()
        key = id(s)
        if key in self._held:
            return
        n = s.nbytes()
        self._held[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(s, self._free, key)

    def _free(self, key) -> None:
        self.live -= self._held.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        # DTensor's sharding propagation runs an op on fake tensors to
        # learn its output's shape (once an op and layout): no device does
        if (isinstance(func, torch._ops.HigherOrderOperator)
                or any(issubclass(t, FakeTensor) for t in types)):
            return func(*args, **kwargs)
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        kind = collective_kind(func.name())
        outs = _tensors(out)
        if kind is not None:
            self.collectives[kind] = self.collectives.get(kind, 0) + sum(
                t.numel() * t.element_size() for t in outs)
        if packet in self._flops:
            self.flops += self._flops[packet](*args, **kwargs, out_val=out)
        ins = _tensors((args, kwargs))
        if not func.is_view and packet.__name__ not in _NO_BYTES:
            fresh = [t for t in outs if not any(t is i for i in ins)]
            self.bytes += sum(t.numel() * t.element_size()
                              for t in ins + fresh)
        for t in outs:
            self.hold(t)
        return out


@contextlib.contextmanager
def plain_kernels():
    """The LM's kernel calls (``nn.attention.flash_attention``,
    ``nn.ssm.ssd_chunk``) routed to their plain versions for the block's
    duration: the dry run traces meta tensors, which no kernel takes (the
    wrappers refuse them) and whose products autograd differentiates."""
    from ..kernels.flash_attention import attention_ref
    from ..kernels.ssd_chunk import ssd_chunk_ref
    from ..nn import attention, ssm
    saved = attention.flash_attention, ssm.ssd_chunk
    attention.flash_attention, ssm.ssd_chunk = attention_ref, ssd_chunk_ref
    try:
        yield
    finally:
        attention.flash_attention, ssm.ssd_chunk = saved


def _local(t):
    return t.to_local() if shd.is_dtensor(t) else t


def lay_out(full, shardings):
    """Each meta leaf of ``full`` as the DTensor its ``Sharding`` gives,
    its local shard in a storage of its own (so a shard's bytes are its
    own, not the whole tensor's)."""
    from torch.distributed.tensor import DTensor

    def one(t, sh):
        d = sh.distribute(t)
        return DTensor.from_local(d.to_local().clone(), d.device_mesh,
                                  d.placements, run_check=False,
                                  shape=d.shape, stride=d.stride())
    return tree.map(one, full, shardings)


def build_step(cfg, sp, mesh, microbatches: int):
    """-> (step, its arguments, the argument trees whose storages the
    step may keep) for one step of ``sp`` under ``mesh`` (the caller
    holds ``shd.use_mesh``), or without a mesh (``mesh=None``: plain
    meta tensors, the whole step on one device)."""
    def laid(full, shardings):
        return full if mesh is None else lay_out(full, shardings(full))

    params = zoo.init(None, cfg, "meta")
    p_sh = (None if mesh is None
            else shd.param_shardings(params, mesh, cfg.moe_shard))
    if sp.kind == "train":
        opt_cfg = adamw.AdamWConfig()
        opt = adamw.init_state(opt_cfg, params)
        accum = torch.bfloat16 if cfg.family == "moe" else torch.float32
        fn = steps.make_train_step(cfg, opt_cfg, microbatches=microbatches,
                                   accum_dtype=accum, param_shardings=p_sh)
        batch = zoo.input_specs(cfg, sp.seq_len, sp.global_batch, "train")
        args = (laid(params, lambda t: p_sh),
                laid(opt, lambda t: shd.param_shardings(t, mesh,
                                                        cfg.moe_shard)),
                batch, 0)
        return fn, args, args[:3]
    params = laid(params, lambda t: p_sh)
    if sp.kind == "prefill":
        batch = zoo.input_specs(cfg, sp.seq_len, sp.global_batch, "prefill")
        batch = laid(batch, lambda t: shd.batch_shardings(t, mesh))
        return steps.make_prefill_step(cfg), (params, batch), (params, batch)
    cache = zoo.cache_specs(cfg, sp.global_batch, sp.seq_len)
    cache = laid(cache, lambda t: shd.cache_shardings(t, mesh))
    tok = zoo.input_specs(cfg, sp.seq_len, sp.global_batch, "decode")
    tok = laid(tok, lambda t: shd.batch_shardings(t, mesh))["token"]
    # the newest token of a full cache: every slot is read
    args = (params, tok, cache, sp.seq_len - 1)
    return steps.make_decode_step(cfg), args, args[:3]


def trace_step(cfg, shape, mesh, microbatches: int = 1) -> dict:
    """One step of ``shape`` (a ``SHAPES`` name or a ``ShapeSpec``) under
    ``mesh`` (or none) through :class:`DeviceTrace`: -> its counts and
    the wall times of building and tracing it."""
    sp = SHAPES[shape] if isinstance(shape, str) else shape
    t0 = time.perf_counter()
    with (contextlib.nullcontext() if mesh is None else
          shd.use_mesh(mesh, sp=cfg.seq_shard_blocks,
                       profile=cfg.shard_profile)):
        fn, args, held = build_step(cfg, sp, mesh, microbatches)
        arg_t = [_local(t) for t in tree.leaves(held)
                 if isinstance(t, torch.Tensor)]
        t_build = time.perf_counter() - t0
        trace = DeviceTrace(arg_t)
        arg_bytes = trace.live
        with plain_kernels(), trace:
            out = fn(*args)
        arg_ids = {id(t.untyped_storage()) for t in arg_t}
        outs = {id(s): s.nbytes() for s in (
            _local(t).untyped_storage() for t in tree.leaves(out)
            if isinstance(t, torch.Tensor))}
    return {"build_s": t_build,
            "trace_s": time.perf_counter() - t0 - t_build,
            "flops": float(trace.flops), "bytes": float(trace.bytes),
            "collectives": dict(trace.collectives),
            "memory": {"argument_bytes": arg_bytes,
                       "output_bytes": sum(n for k, n in outs.items()
                                           if k not in arg_ids),
                       "temp_bytes": trace.peak - arg_bytes,
                       "alias_bytes": sum(n for k, n in outs.items()
                                          if k in arg_ids),
                       "peak_bytes": trace.peak}}


def production_microbatches(sp, multi_pod: bool) -> int:
    """The microbatches of a training cell (the JAX package's rule)."""
    dp = 32 if multi_pod else 16
    return max(min(16, sp.global_batch // dp), 1)


def run_cell(arch: str, shape, multi_pod: bool, mesh, cfg=None) -> dict:
    """The record of one cell traced under ``mesh`` (a mesh of the fake
    world) at ``shape`` (a ``SHAPES`` name or a ``ShapeSpec``); ``cfg``
    (default ``get_config(arch)``) lets a caller trace a changed config
    (``launch/hillclimb.py``) or a reduced one."""
    sp = SHAPES[shape] if isinstance(shape, str) else shape
    shape_name = sp.name
    if shape_name == "long_500k" and arch not in SUBQUADRATIC:
        return {"arch": arch, "shape": shape_name,
                "multi_pod": multi_pod, "status": "skipped",
                "reason": "full-attention arch; 500k needs sub-quadratic "
                          "mixing (DESIGN.md §4)"}
    cfg = get_config(arch) if cfg is None else cfg
    try:
        cost = trace_step(cfg, sp, mesh, 1)
        mb, memory = 1, cost["memory"]
        if (sp.kind == "train" and not multi_pod
                and production_microbatches(sp, multi_pod) > 1
                and not os.environ.get("DRYRUN_SKIP_MEM_VARIANT")):
            mb = production_microbatches(sp, multi_pod)
            memory = trace_step(cfg, sp, mesh, mb)["memory"]
        pc = cfg.param_counts()
        colls = dict(cost["collectives"])
        colls["total"] = sum(colls.values())
        rec = {
            "arch": arch, "shape": shape_name, "multi_pod": multi_pod,
            "status": "ok", "chips": mesh.size, "microbatches": mb,
            "lower_s": round(cost["build_s"], 1),
            "compile_s": round(cost["trace_s"], 1),
            "hlo_flops_per_chip": cost["flops"],
            "hlo_bytes_per_chip": cost["bytes"],
            "collective_bytes_per_chip": colls,
            "memory": memory,
            "params_total": pc["total"], "params_active": pc["active"],
            "compute_s": cost["flops"] / HW["peak_bf16_flops"],
            "memory_s": cost["bytes"] / HW["hbm_bw"],
            "collective_s": colls["total"] / HW["nvlink_bw"],
        }
        terms = {k: rec[k] for k in ("compute_s", "memory_s",
                                     "collective_s")}
        rec["dominant"] = max(terms, key=terms.get)
        return rec
    except Exception as e:  # noqa: BLE001 — record, don't crash the sweep
        return {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
                "status": "error", "error": f"{type(e).__name__}: {e}",
                "trace": traceback.format_exc()[-2000:]}


@dataclasses.dataclass
class World:
    """The fake world of a production mesh (or of a ("data", "model")
    mesh of ``shape``), made on entry and ended on exit; ``mesh`` is its
    mesh."""
    multi_pod: bool = False
    shape: tuple | None = None
    mesh: object = None

    def __enter__(self):
        if self.shape is not None:
            n = 1
            for s in self.shape:
                n *= s
            fake_world(n)
        else:
            fake_world(512 if self.multi_pod else 256)
        try:
            self.mesh = (make_production_mesh(multi_pod=self.multi_pod,
                                              device="meta")
                         if self.shape is None else
                         make_mesh(self.shape, ("data", "model"), "meta"))
        except BaseException:
            release_world()
            raise
        return self

    def __exit__(self, *exc):
        release_world()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="results/dryrun.json")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else ARCH_IDS
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    results = []
    if os.path.exists(args.out):
        with open(args.out) as fh:
            results = json.load(fh)
    done = {(r["arch"], r["shape"], r["multi_pod"]) for r in results
            if r.get("status") in ("ok", "skipped")}

    for mp in meshes:
        todo = [(a, s) for a in archs for s in shapes
                if (a, s, mp) not in done]
        if not todo:
            continue
        with World(mp) as world:
            for a, s in todo:
                rec = run_cell(a, s, mp, world.mesh)
                results = [r for r in results
                           if not (r["arch"] == a and r["shape"] == s
                                   and r["multi_pod"] == mp)]
                results.append(rec)
                os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
                with open(args.out, "w") as fh:
                    json.dump(results, fh, indent=1)
                extra = (f"dom={rec['dominant']} "
                         f"trace={rec['compile_s']}s "
                         f"flops/device={rec['hlo_flops_per_chip']:.4g}"
                         if rec["status"] == "ok" else
                         rec.get("reason", rec.get("error", ""))[:120])
                print(f"[{'2pod' if mp else '1pod'}] {a} × {s}: "
                      f"{rec['status']} {extra}", flush=True)
    return results


if __name__ == "__main__":
    main()
