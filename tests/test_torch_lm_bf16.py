"""The port's LM forward and decode against the JAX package in each reduced
config's own bfloat16, with JAX's ``zoo.init`` weights carried across:
‖Δ‖ / ‖ref‖ <= 2e-2, the tolerance of tests/test_lm_smoke.py.

The two packages round bfloat16 at different places (the flash route's
plain version keeps its probabilities in float32; XLA fuses elementwise
ops), so a router's near-tie can pick another expert for a token: on
grok's reduced config 2 of 128 tokens a layer route differently.  The
forward is therefore compared over every position's logits, where such a
token weighs as one row among B·S; float32 holds every position to 1e-4
(``test_torch_lm.py``), MoE routing exactly (``test_torch_lm_nn.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip(
    "repro.dist", reason="repro.dist (sharding subsystem) not present")

from repro.configs import ARCH_IDS, get_config
from repro.lm import model_zoo as jzoo
from repro.lm import transformer as jtfm
from repro.lm import whisper as jwhi
from repro_torch.lm import model_zoo as pzoo
from repro_torch.lm import transformer as ptfm
from repro_torch.lm import whisper as pwhi
from repro_torch.lm.params import from_numpy

torch.set_num_threads(1)
REL = 2e-2
B, S, CACHE, STEPS = 2, 64, 16, 4


def rel_err(got, want) -> float:
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert got.shape == want.shape
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def setup(arch):
    cfg = get_config(arch, reduced=True)
    assert cfg.dtype == "bfloat16"
    jp = jzoo.init(jax.random.PRNGKey(0), cfg)
    pp = from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    extra = None
    if cfg.family in ("vlm", "audio"):
        n = cfg.prefix_tokens if cfg.family == "vlm" else cfg.enc_seq
        extra = jnp.asarray((0.02 * rng.standard_normal(
            (B, n, cfg.d_model))).astype(np.float32)).astype(jnp.bfloat16)
    return cfg, jp, pp, toks, extra


def extra_torch(extra):
    return torch.from_numpy(np.array(extra.astype(jnp.float32))).bfloat16()


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_bf16(arch):
    cfg, jp, pp, toks, extra = setup(arch)
    if cfg.family == "audio":
        want, _ = jax.jit(lambda p, f, t: jwhi.forward(cfg, p, f, t))(
            jp, extra, jnp.asarray(toks))
        got, _ = pwhi.forward(cfg, pp, extra_torch(extra),
                              torch.from_numpy(toks))
    else:
        want, _ = jax.jit(lambda p, t, e: jtfm.forward(
            cfg, p, tokens=t, prefix_embeds=e))(jp, jnp.asarray(toks), extra)
        got, _ = ptfm.forward(cfg, pp, tokens=torch.from_numpy(toks),
                              prefix_embeds=None if extra is None
                              else extra_torch(extra))
    assert got.dtype == torch.bfloat16
    assert rel_err(got, want) <= REL


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decode_bf16(arch):
    cfg, jp, pp, toks, extra = setup(arch)
    jc = jzoo.make_cache(cfg, jp, B, CACHE, frames=extra)
    pc = pzoo.make_cache(cfg, pp, B, CACHE, device="cpu",
                         frames=None if extra is None else extra_torch(extra))
    step = jax.jit(lambda p, t, c, pos: jzoo.decode_fn(cfg, p, t, c, pos))
    for pos in range(STEPS):
        want, jc = step(jp, jnp.asarray(toks[:, pos]), jc, jnp.int32(pos))
        got, pc = pzoo.decode_fn(cfg, pp, torch.from_numpy(toks[:, pos]), pc,
                                 pos)
        assert rel_err(got, want) <= REL, pos
