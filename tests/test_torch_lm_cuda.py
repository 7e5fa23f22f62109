"""The LM's kernel routes on the card: a prefill through the
``flash_attention`` / ``ssd_chunk`` kernels against the same prefill with
each kernel's plain version routed in, on reduced configs, with the
launches the routes name (``model_zoo.prefill_launches``).  float32:
max|Δ| <= 1e-3 · max(1, max|plain|) (the kernels multiply in 3xTF32);
bfloat16: ‖Δ‖ / ‖plain‖ <= 2e-2.  Every test needs a CUDA device and skips
without one; ``python3 chip_smoke.py`` drives the same routes at full
width.  Imports no JAX."""
import dataclasses

import pytest
import torch

from repro_torch import kernels
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import attention_ref
from repro_torch.kernels.ssd_chunk import ssd_chunk_ref
from repro_torch.lm import model_zoo as zoo
from repro_torch.lm import steps
from repro_torch.nn import attention as attn
from repro_torch.nn import ssm

ARCHS = ("olmo-1b", "gemma-7b", "qwen2-72b", "mamba2-2.7b",
         "whisper-large-v3", "paligemma-3b")


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _batch(cfg, dev, gen, b=2, s=128):
    batch = {"tokens": torch.randint(0, cfg.vocab, (b, s + 1), generator=gen,
                                     device=dev)}
    n = {"vlm": cfg.prefix_tokens, "audio": cfg.enc_seq}.get(cfg.family)
    if n:
        key = "patches" if cfg.family == "vlm" else "frames"
        batch[key] = 0.02 * torch.randn((b, n, cfg.d_model), generator=gen,
                                        device=dev).to(getattr(torch,
                                                               cfg.dtype))
    return batch


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_kernel_route_matches_plain_route(arch, dtype, monkeypatch):
    dev = _cuda()
    cfg = dataclasses.replace(get_config(arch, reduced=True), dtype=dtype)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = zoo.init(gen, cfg, dev)
    batch = _batch(cfg, dev, gen)
    prefill = steps.make_prefill_step(cfg)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    got = prefill(params, batch)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    want = zoo.prefill_launches(cfg)
    assert launches == {**dict.fromkeys(launches, 0), **want}
    monkeypatch.setattr(attn, "flash_attention", attention_ref)
    monkeypatch.setattr(ssm, "ssd_chunk", ssd_chunk_ref)
    plain = prefill(params, batch)
    assert torch.isfinite(got.float()).all()
    if dtype == "float32":
        err = (got - plain).abs().max().item()
        assert err <= 1e-3 * max(1.0, plain.abs().max().item())
    else:
        d = (got.float() - plain.float()).norm() / plain.float().norm()
        assert d.item() <= 2e-2


@pytest.mark.cuda
def test_decode_launches_no_kernel():
    dev = _cuda()
    cfg = get_config("olmo-1b", reduced=True)
    params = zoo.init(torch.Generator(device=dev).manual_seed(0), cfg, dev)
    cache = zoo.make_cache(cfg, params, 2, 16, device=dev)
    step = steps.make_decode_step(cfg)
    tok = torch.zeros(2, dtype=torch.int32, device=dev)
    kernels.reset_launch_counts()
    for pos in range(4):
        tok, logits, cache = step(params, tok, cache, pos)
    torch.cuda.synchronize()
    assert not any(kernels.launch_counts().values())
    assert torch.isfinite(logits.float()).all()
