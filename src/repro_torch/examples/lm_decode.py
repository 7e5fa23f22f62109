"""Serve a small LM with batched requests: batched greedy decode with a
KV cache across three architecture families (dense / SSM / hybrid),
through the one decode step of the model zoo.  The port of the JAX
package's ``examples/lm_decode.py``.

    PYTHONPATH=src python -m repro_torch.examples.lm_decode
    PYTHONPATH=src python -m repro_torch.examples.lm_decode --device cpu
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import get_config
from ..device import resolve_device
from ..lm import model_zoo as zoo
from ..lm import steps as steps_mod

ARCHS = ("olmo-1b", "mamba2-2.7b", "recurrentgemma-2b")
B, GEN, CACHE = 4, 12, 64


def decode(cfg, params, tok, device) -> np.ndarray:
    """``GEN`` greedy tokens from the first tokens ``tok`` (B,) through a
    fresh cache.  -> (B, GEN) int32."""
    cache = zoo.make_cache(cfg, params, tok.shape[0], CACHE, device=device)
    step = steps_mod.make_decode_step(cfg)
    toks = []
    for pos in range(GEN):
        tok, _logits, cache = step(params, tok, cache, pos)
        toks.append(tok.cpu().numpy())
    return np.stack(toks, 1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    rng = np.random.default_rng(0)
    for arch in ARCHS:
        cfg = get_config(arch, reduced=True)
        params = zoo.init(torch.Generator().manual_seed(0), cfg, dev)
        tok = torch.as_tensor(rng.integers(0, cfg.vocab, (B,)),
                              dtype=torch.int32, device=dev)
        t0 = time.time()
        toks = decode(cfg, params, tok, dev)
        dt = time.time() - t0
        print(f"{arch:20s} generated {B}x{GEN} tokens in {dt:5.2f}s "
              f"({B*GEN/dt:6.1f} tok/s)  sample: {toks[0][:8].tolist()}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
