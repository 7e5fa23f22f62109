"""Training entry point (the port of ``repro.launch.train``): data,
checkpoint/restart and the train loop under a mesh, on the GPU unless
``--device cpu`` is given.

Runs real steps and the full fault-tolerance loop: restore from the
newest committed checkpoint, atomic saves every ``--ckpt-every`` steps and
on SIGTERM, deterministic data resume.  The step runs with
``torch.use_deterministic_algorithms(True, warn_only=True)`` (and cuBLAS's
fixed workspace), so a resumed run gives the losses of an uninterrupted
one.

    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \\
        --steps 8 --batch 4 --seq 2048 --microbatches 2 --ckpt /tmp/ckpt
    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \\
        --reduced --device cpu --steps 20 --batch 8 --seq 128

On the card attention's gradient runs through the ``flash_attention``
backward kernel and an SSD layer's through the ``ssd_chunk`` one:

    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-2.7b \\
        --steps 8 --batch 4 --seq 2048 --microbatches 2

A world of one (no torchrun, or one rank) trains without a mesh: plain
tensors, no process group.  Launched on more ranks, the mesh is
``local_mesh()`` ((1, world) over ("data", "model")); with
``--production-mesh`` it is ``make_production_mesh()`` (256 ranks, refused
in any other world).  Under a mesh, params and optimizer state are
DTensors laid out by ``dist.sharding.param_shardings``; every rank draws
the same batch and the step lays it out; rank 0 prints the step lines
and writes the checkpoints.  Rehearsed on the CPU over gloo:

    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --arch olmo-1b --reduced --device cpu --steps 3 --batch 4 --seq 32
"""
from __future__ import annotations

import argparse
import os
import signal
import time

import torch

from ..ckpt.manager import CheckpointManager
from ..configs import get_config
from ..data.loader import TokenStream
from ..device import resolve_device
from ..dist import compress as compress_mod
from ..dist import sharding as shd
from ..lm import model_zoo as zoo
from ..lm import steps as steps_mod
from ..lm.transformer import dtype_of
from .mesh import local_mesh, make_production_mesh, world_size
from ..optim import adamw


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=5)
    ap.add_argument("--production-mesh", action="store_true",
                    help="the 16 x 16 production mesh: 256 ranks, one a "
                         "device (torchrun --nproc-per-node ...)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--compress", default=None, choices=["int8", "topk"],
                    help="compress the gradients with this dist.compress "
                         "codec (error feedback rides in opt_state['ef'])")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    return ap.parse_args(argv)


def main(argv=None, history: list | None = None, mesh=None) -> list:
    """Train; -> the losses of the steps run.  ``history``, if given, gets
    each step's ``{"loss", "grad_norm"}`` as floats.  ``mesh`` (a
    ``launch.mesh.Mesh`` the caller made and releases) runs the steps
    under it in place of the mesh the world gives: the way to drive the
    sharded path in a world of one."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    # cuBLAS takes a fixed workspace only if this is set before its first
    # call in the process
    workspace = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    was_deterministic = (torch.are_deterministic_algorithms_enabled(),
                         torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    old_handler = signal.getsignal(signal.SIGTERM)
    try:
        if mesh is None and args.production_mesh:
            try:
                mesh = make_production_mesh(device=dev)
            except RuntimeError as e:
                raise SystemExit(f"--production-mesh: {e}") from None
        elif mesh is None and world_size() > 1:
            mesh = local_mesh(dev)
        if mesh is None:
            return _train(args, dev, None, history)
        cfg = get_config(args.arch, reduced=args.reduced)
        with shd.use_mesh(mesh, sp=cfg.seq_shard_blocks,
                          profile=cfg.shard_profile):
            return _train(args, dev, mesh, history)
    finally:
        signal.signal(signal.SIGTERM, old_handler)
        if workspace is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
        torch.use_deterministic_algorithms(was_deterministic[0],
                                           warn_only=was_deterministic[1])


def _train(args, dev, mesh, history) -> list:
    cfg = get_config(args.arch, reduced=args.reduced)
    opt_cfg = adamw.AdamWConfig(state_dtype="float32")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = zoo.init(gen, cfg, dev)
    opt_state = adamw.init_state(opt_cfg, params)
    if args.compress:
        opt_state["ef"] = compress_mod.init_error_feedback(params)
    p_sh = o_sh = None
    lead = True
    if mesh is not None:
        # every rank drew the same params: each keeps its shards
        p_sh = shd.param_shardings(params, mesh, cfg.moe_shard)
        o_sh = shd.param_shardings(opt_state, mesh, cfg.moe_shard)
        params = shd.distribute(params, p_sh)
        opt_state = shd.distribute(opt_state, o_sh)
        lead = torch.distributed.get_rank() == 0

    stream = TokenStream(vocab=cfg.vocab, batch=args.batch,
                         seq_len=args.seq, seed=args.seed)
    start_step = 0
    mgr = CheckpointManager(args.ckpt) if args.ckpt else None
    if mgr is not None:
        restored = mgr.restore(params, opt_state, shardings=(
            None if mesh is None else {"params": p_sh, "opt": o_sh}))
        if restored is not None:
            start_step, params, opt_state, dstate = restored
            stream = TokenStream.from_state(dstate, vocab=cfg.vocab,
                                            batch=args.batch,
                                            seq_len=args.seq)
            if lead:
                print(f"[restore] resumed at step {start_step}", flush=True)

    train_step = steps_mod.make_train_step(
        cfg, opt_cfg, microbatches=args.microbatches, param_shardings=p_sh,
        compressor=(compress_mod.make_compressor(args.compress)
                    if args.compress else None))

    stop = {"now": False}

    def _sig(_s, _f):  # preemption hook: save and exit cleanly
        stop["now"] = True
    signal.signal(signal.SIGTERM, _sig)

    dt = dtype_of(cfg)
    losses = []
    for step in range(start_step, args.steps):
        t0 = time.perf_counter()        # dt: the batch's copy included
        batch = {"tokens": torch.from_numpy(stream.next()).to(dev)}
        if cfg.family == "vlm":
            batch["patches"] = torch.zeros(
                (args.batch, cfg.prefix_tokens, cfg.d_model), dtype=dt,
                device=dev)
        if cfg.family == "audio":
            batch["frames"] = 0.01 * torch.ones(
                (args.batch, cfg.enc_seq, cfg.d_model), dtype=dt,
                device=dev)
        params, opt_state, metrics = train_step(params, opt_state, batch,
                                                step)
        loss = float(metrics["loss"])       # waits for the step
        losses.append(loss)
        if history is not None:
            history.append({"loss": loss,
                            "grad_norm": float(metrics["grad_norm"])})
        if lead:
            print(f"step {step}: loss={loss:.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f} "
                  f"dt={time.perf_counter() - t0:.4f}s", flush=True)
        if mgr is not None and (
                (step + 1) % args.ckpt_every == 0 or stop["now"]
                or step + 1 == args.steps):
            mgr.save(step + 1, params, opt_state, stream.state())
        if stop["now"]:
            if lead:
                print("[preempt] checkpoint saved; exiting", flush=True)
            break
    return losses


if __name__ == "__main__":
    main()
