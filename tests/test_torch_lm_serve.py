"""The LM half of the port's serving CLI (``repro_torch.launch.serve``)
against the JAX package: ``serve_lm`` — random prompts teacher-forced
through decode, then greedy tokens — gives JAX's tokens from the same
weights (``zoo.init`` carried across), on every architecture's reduced
config.  The exact comparison runs in float32, where no near-tie of the
logits can flip an argmax between the two packages' roundings; the
bfloat16 CLI of both packages is compared on olmo-1b.  Then the CLI
itself with ``--reduced --device cpu``, and its refusals."""
import argparse
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip(
    "repro.dist", reason="repro.dist (sharding subsystem) not present")

from repro.configs import ARCH_IDS, get_config
from repro.launch import serve as jserve
from repro.lm import model_zoo as jzoo
from repro.lm import steps as jsteps
from repro_torch.launch import serve as pserve
from repro_torch.lm.params import from_numpy

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN = dict(batch=2, prompt_len=8, gen=6, cache_len=16)


def jax_greedy(cfg, params, batch, prompt_len, gen, cache_len):
    """``repro.launch.serve.serve_lm``'s loop without its mesh (the JAX
    CLI's mesh fails on MoE archs under this jax, ROADMAP queue 3), the
    audio frames in the model dtype."""
    rng = np.random.default_rng(0)
    dt = jnp.bfloat16 if cfg.dtype == "bfloat16" else jnp.float32
    frames = None
    if cfg.family == "audio":
        frames = 0.01 * jnp.ones((batch, cfg.enc_seq, cfg.d_model), dt)
    cache = jzoo.make_cache(cfg, params, batch, cache_len, frames=frames)
    decode = jax.jit(jsteps.make_decode_step(cfg))
    prompts = rng.integers(0, cfg.vocab, (batch, prompt_len), dtype=np.int32)
    tok = jnp.asarray(prompts[:, 0])
    for pos in range(prompt_len - 1):
        _, _, cache = decode(params, tok, cache, jnp.int32(pos))
        tok = jnp.asarray(prompts[:, pos + 1])
    out = []
    for g in range(gen):
        tok, _, cache = decode(params, tok, cache, jnp.int32(prompt_len + g))
        out.append(np.asarray(tok))
    return np.stack(out, 1)


def port_greedy(arch, params, monkeypatch=None, cfg=None):
    if cfg is not None:
        monkeypatch.setattr(pserve, "get_config", lambda a, reduced: cfg)
    args = argparse.Namespace(arch=arch, reduced=True, device="cpu", **RUN)
    return pserve.serve_lm(
        args, from_numpy(jax.tree.map(np.asarray, params), "cpu"))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_serve_lm_tokens_equal_jax(arch, monkeypatch):
    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              dtype="float32")
    params = jzoo.init(jax.random.PRNGKey(0), cfg)
    want = jax_greedy(cfg, params, **RUN)
    got = port_greedy(arch, params, monkeypatch, cfg)
    assert got.shape == (RUN["batch"], RUN["gen"])
    assert np.array_equal(got, want)


def test_serve_lm_bf16_cli_equals_jax_cli(capsys):
    """Both packages' CLIs in the config's own bfloat16: JAX's serve_lm
    (its mesh included) and the port's from the same weights."""
    argv = ["--arch", "olmo-1b", "--reduced", "--batch", "2",
            "--prompt-len", "8", "--gen", "6", "--cache-len", "16"]
    want = jserve.main(argv)
    cfg = get_config("olmo-1b", reduced=True)
    params = jzoo.init(jax.random.PRNGKey(0), cfg)
    assert np.array_equal(jax_greedy(cfg, params, **RUN), np.asarray(want))
    assert np.array_equal(port_greedy("olmo-1b", params), np.asarray(want))


def test_cli_reduced_cpu():
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "mamba2-2.7b", "--reduced", "--device", "cpu", "--batch", "2",
         "--prompt-len", "6", "--gen", "3", "--cache-len", "16"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    lines = res.stdout.splitlines()
    assert lines[0].startswith("cpu: mamba2-2.7b-smoke (2 layers")
    assert "tok/s" in lines[0]


@pytest.mark.parametrize("arch", ["whisper-large-v3", "paligemma-3b"])
def test_cli_main_serves_lm(arch, capsys):
    gen = pserve.main(["--arch", arch, "--reduced", "--device", "cpu",
                       "--batch", "3", "--prompt-len", "5", "--gen", "2"])
    assert gen.shape == (3, 2)
    cfg = get_config(arch, reduced=True)
    assert ((0 <= gen) & (gen < cfg.vocab)).all()
    assert capsys.readouterr().out.startswith("cpu: ")


def test_cli_refusals():
    with pytest.raises(SystemExit, match="--mesh-data is the PCN engine"):
        pserve.main(["--arch", "olmo-1b", "--reduced", "--device", "cpu",
                     "--mesh-data", "2"])
    with pytest.raises(SystemExit, match="is neither a PCN model"):
        pserve.main(["--arch", "gpt-5", "--device", "cpu"])


def test_serve_lm_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is servable")
    with pytest.raises(RuntimeError, match="CUDA device"):
        pserve.main(["--arch", "olmo-1b", "--reduced"])
