"""The port's LM entry points (``repro_torch.lm``: ``forward``,
``model_zoo.{prefill_fn,loss_fn,make_cache,decode_fn}``, ``steps``) against
the JAX package on every architecture's reduced config in float32, with
JAX's ``zoo.init`` weights carried across by ``from_numpy``:
logits within 1e-4 · max(1, max|ref|), decode over 4 steps (caches
included), a decode continued from JAX's own cache
(``from_numpy``), the int8 KV cache, and teacher-forced decode
against the port's own forward.  The bfloat16 runs are in
``test_torch_lm_bf16.py``."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip(
    "repro.dist", reason="repro.dist (sharding subsystem) not present")

from repro.configs import ARCH_IDS, get_config
from repro.lm import model_zoo as jzoo
from repro.lm import steps as jsteps
from repro.lm import transformer as jtfm
from repro.lm import whisper as jwhi
from repro_torch.lm import model_zoo as pzoo
from repro_torch.lm import steps as psteps
from repro_torch.lm import transformer as ptfm
from repro_torch.lm import whisper as pwhi
from repro_torch.lm.params import from_numpy

torch.set_num_threads(1)
TOL = 1e-4
B, S, CACHE, STEPS = 2, 64, 16, 4


def close(got, want, tol=TOL):
    got = got.detach().float().numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    lim = tol * max(1.0, float(np.abs(want).max()))
    assert err <= lim, f"max|Δ| {err:.3g} > {lim:.3g}"


def config(arch, **kw):
    return dataclasses.replace(get_config(arch, reduced=True),
                               dtype="float32", **kw)


def batches(cfg, seed=0):
    """The same batch for both packages: tokens (B, S+1), and patches or
    frames in the model dtype."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    jb, pb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    extra = {"vlm": ("patches", cfg.prefix_tokens),
             "audio": ("frames", cfg.enc_seq)}.get(cfg.family)
    if extra:
        a = (0.02 * rng.standard_normal((B, extra[1], cfg.d_model))
             ).astype(np.float32)
        jb[extra[0]] = jnp.asarray(a)
        pb[extra[0]] = torch.from_numpy(a)
    return jb, pb


@functools.lru_cache(maxsize=None)
def jax_run(arch, kv_quant=False):
    """JAX's params, batch, forward / prefill / loss, and 4 decode steps
    (logits, and the cache after each step), computed once per config."""
    cfg = config(arch, kv_quant=kv_quant)
    params = jzoo.init(jax.random.PRNGKey(0), cfg)
    jb, _ = batches(cfg)

    @jax.jit
    def full(p, b):
        inp = b["tokens"][:, :-1]
        if cfg.family == "audio":
            fwd = jwhi.forward(cfg, p, b["frames"], inp)
        else:
            fwd = jtfm.forward(cfg, p, tokens=inp,
                               prefix_embeds=b.get("patches"))
        return (fwd, jsteps.make_prefill_step(cfg)(p, b),
                jzoo.loss_fn(cfg, p, b))

    fwd, prefill, loss = full(params, jb)
    decode = jax.jit(jsteps.make_decode_step(cfg))
    cache = jzoo.make_cache(cfg, params, B, CACHE, frames=jb.get("frames"))
    caches, steps = [jax.tree.map(np.asarray, cache)], []
    for pos in range(STEPS):
        nxt, logits, cache = decode(params, jb["tokens"][:, pos], cache,
                                    jnp.int32(pos))
        steps.append((np.asarray(nxt), np.asarray(logits)))
        caches.append(jax.tree.map(np.asarray, cache))
    return dict(cfg=cfg, params=jax.tree.map(np.asarray, params), fwd=fwd,
                prefill=prefill, loss=loss, steps=steps, caches=caches)


def port(arch, kv_quant=False):
    ref = jax_run(arch, kv_quant)
    _, pb = batches(ref["cfg"])
    return ref, from_numpy(ref["params"], device="cpu"), pb


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_logits(arch):
    ref, params, pb = port(arch)
    cfg, inp = ref["cfg"], pb["tokens"][:, :-1]
    if cfg.family == "audio":
        logits, aux = pwhi.forward(cfg, params, pb["frames"], inp)
    else:
        logits, aux = ptfm.forward(cfg, params, tokens=inp,
                                   prefix_embeds=pb.get("patches"))
    close(logits, ref["fwd"][0])
    close(aux, ref["fwd"][1])


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_prefill_and_loss(arch):
    ref, params, pb = port(arch)
    cfg = ref["cfg"]
    close(psteps.make_prefill_step(cfg)(params, pb), ref["prefill"])
    close(pzoo.prefill_fn(cfg, params, pb), ref["prefill"])
    loss, aux = pzoo.loss_fn(cfg, params, pb)
    close(loss, ref["loss"][0])
    close(aux, ref["loss"][1])


def _decode(cfg, params, cache, tokens, start):
    """Yield each step's (next token, logits, cache): a generator, as the
    attention caches are updated in place by the step after."""
    step = psteps.make_decode_step(cfg)
    for pos in range(start, STEPS):
        nxt, logits, cache = step(params, tokens[:, pos], cache, pos)
        yield nxt, logits, cache


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decode_steps(arch):
    ref, params, pb = port(arch)
    cfg = ref["cfg"]
    cache = pzoo.make_cache(cfg, params, B, CACHE, frames=pb.get("frames"),
                            device="cpu")
    for want, have in zip(jax.tree.leaves(ref["caches"][0]),
                          jax.tree.leaves(cache)):
        close(have, want)
    for (nxt, logits, cache), (want_nxt, want), want_cache in zip(
            _decode(cfg, params, cache, pb["tokens"], 0), ref["steps"],
            ref["caches"][1:]):
        close(logits, want)
        assert nxt.dtype == torch.int32
        assert np.array_equal(nxt.numpy(), want_nxt)
        leaves = jax.tree.leaves(cache)
        assert len(leaves) == len(jax.tree.leaves(want_cache))
        for have, w in zip(leaves, jax.tree.leaves(want_cache)):
            close(have, w)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decode_continues_from_jax_cache(arch):
    """Two decode steps of JAX's, its cache carried across, two of the
    port's: the port's attention / SSM / RG-LRU / cross caches mean what
    JAX's mean."""
    ref, params, pb = port(arch)
    cache = from_numpy(ref["caches"][2], device="cpu")
    for (_, logits, _), (_, want) in zip(
            _decode(ref["cfg"], params, cache, pb["tokens"], 2),
            ref["steps"][2:]):
        close(logits, want)


def test_kv_quant_decode():
    ref, params, pb = port("olmo-1b", kv_quant=True)
    cfg = ref["cfg"]
    cache = pzoo.make_cache(cfg, params, B, CACHE, device="cpu")
    assert cache[0]["k"].dtype == torch.int8
    for (_, logits, cache), (_, want), want_cache in zip(
            _decode(cfg, params, cache, pb["tokens"], 0), ref["steps"],
            ref["caches"][1:]):
        worst = 0
        for have, w in zip(cache, want_cache):
            for name in ("k", "v"):
                worst = max(worst, int(np.abs(
                    have[name].numpy().astype(int)
                    - w[name].astype(int)).max()))
            close(have["ks"], w["ks"])
            close(have["vs"], w["vs"])
        assert worst <= 1                   # int8 codes within 1 of JAX's
        close(logits, want, TOL if worst == 0 else 1e-2)


@pytest.mark.parametrize("arch", ["olmo-1b", "gemma-7b", "mamba2-2.7b",
                                  "recurrentgemma-2b"])
def test_decode_matches_own_forward(arch):
    """Teacher-forced decode logits == the port's full forward logits
    (cache correctness, as tests/test_lm_smoke.py checks JAX's)."""
    ref, params, pb = port(arch)
    cfg = ref["cfg"]
    toks = pb["tokens"][:, :9]
    full, _ = ptfm.forward(cfg, params, tokens=toks[:, :-1])
    cache = pzoo.make_cache(cfg, params, B, CACHE, device="cpu")
    for pos in range(8):
        logits, cache = pzoo.decode_fn(cfg, params, toks[:, pos], cache, pos)
        torch.testing.assert_close(logits, full[:, pos], rtol=TOL, atol=TOL)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_prefill_calls_the_kernels_its_routes_name(arch, monkeypatch):
    """The wrappers a prefill calls (on the CPU they run their plain
    versions) are those ``prefill_launches`` names, once a layer."""
    from repro_torch.nn import attention as pattn
    from repro_torch.nn import ssm as pssm
    calls = {"flash_attention": 0, "ssd_chunk": 0}

    def spy(module, name):
        real = getattr(module, name)

        def counted(*a, **k):
            calls[name] += 1
            return real(*a, **k)
        monkeypatch.setattr(module, name, counted)
    spy(pattn, "flash_attention")
    spy(pssm, "ssd_chunk")
    ref, params, pb = port(arch)
    pzoo.prefill_fn(ref["cfg"], params, pb)
    assert calls == pzoo.prefill_launches(ref["cfg"])
    assert sum(calls.values()) == {"recurrentgemma-2b": 0, "paligemma-3b": 0,
                                   "whisper-large-v3": 4}.get(arch, 2)
