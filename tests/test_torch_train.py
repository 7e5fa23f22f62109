"""The port's train step (``repro_torch.lm.steps.make_train_step``)
against the JAX package's, without a mesh, on one reduced config per
family in float32, from the same params and the same mid-training
AdamW state (both carried across by ``from_numpy``) at step
1000 (``lr_scale`` = 1): grads per leaf within 1e-4 · max(1, max|g|);
loss and grad norm within 1e-5 relative; params, m and v per leaf within
1e-5 · max(1, max|·|); microbatches 1 and 2, compression none and int8.
int8 quantization is discontinuous: where g + ef sits within float32
noise of a rounding tie (|g/s| ≈ k + 0.5), the packages' codes differ by
one.  The int8 cases find those elements from m (the quantized grad is
(m − b1·m₀) / (1 − b1)), require each to differ by exactly one step s =
max|dg| / 127, and hold every other element to the limits above.  Their
share of a leaf is bounded by the grads' own limit: a difference of at
most 1e-4 · max|g| = 0.0127 s reaches a tie from 2 · 0.0127 of the values
at most.
Also: remat on and off give equal grads, ``FlashAttentionFn`` on the CPU
gives plain autograd's grads, and a step calls the kernels as
``model_zoo.train_launches`` counts."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip(
    "repro.dist", reason="repro.dist (sharding subsystem) not present")

from repro.configs import get_config
from repro.dist import compress as jcompress
from repro.lm import model_zoo as jzoo
from repro.lm import steps as jsteps
from repro.optim import adamw as jadamw
from repro_torch import tree
from repro_torch.dist import compress as pcompress
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.ssd_chunk import ops as ssd_ops
from repro_torch.lm import model_zoo as pzoo
from repro_torch.lm import steps as psteps
from repro_torch.lm.params import from_numpy
from repro_torch.nn import attention as pattn
from repro_torch.nn import ssm as pssm
from repro_torch.optim import adamw as padamw

torch.set_num_threads(1)
FAMILIES = ("olmo-1b", "grok-1-314b", "mamba2-2.7b", "recurrentgemma-2b",
            "paligemma-3b", "whisper-large-v3")
B, S, STEP = 2, 64, 1000


def close(got, want, tol):
    got = got.detach().float().numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert got.shape == want.shape
    err = float(np.abs(got - want).max()) if got.size else 0.0
    lim = tol * max(1.0, float(np.abs(want).max())) if want.size else tol
    assert err <= lim, f"max|Δ| {err:.3g} > {lim:.3g}"


def rel(got, want, tol):
    got, want = float(got), float(want)
    assert abs(got - want) <= tol * abs(want), (got, want)


def trees_close(got, want, tol):
    got_l, want_l = tree.leaves(got), jax.tree.leaves(want)
    assert len(got_l) == len(want_l)
    for path, g, w in zip(tree.paths(got), got_l, want_l):
        try:
            close(g, w, tol)
        except AssertionError as e:
            raise AssertionError(f"{path}: {e}") from None


def int8_ties(pst, jst, m0, b1=0.9):
    """Per leaf, a bool mask of the elements whose m or error feedback is
    off JAX's by more than 1e-5 · max(1, max|·|), each checked to be one
    quantization step apart in the int8 codes."""
    masks = []
    for got, want, old, ef_p, ef_j in zip(
            tree.leaves(pst["m"]), jax.tree.leaves(jst["m"]),
            jax.tree.leaves(m0), tree.leaves(pst["ef"]),
            jax.tree.leaves(jst["ef"])):
        got, want = got.numpy(), np.asarray(want)
        ef_p, ef_j = ef_p.numpy(), np.asarray(ef_j)
        old = np.asarray(old, np.float32)
        tie = ((np.abs(got - want) > 1e-5 * max(1.0, np.abs(want).max()))
               | (np.abs(ef_p - ef_j) > 1e-5 * max(1.0, np.abs(ef_j).max())))
        dg_p = (got - b1 * old) / (1 - b1)
        dg_j = (want - b1 * old) / (1 - b1)
        step = np.abs(dg_j).max() / 127
        assert np.allclose(np.abs(dg_p - dg_j)[tie], step, rtol=1e-2)
        assert tie.sum() <= max(1, 2 * 1e-4 * 127 * tie.size)
        masks.append(tie)
    return masks


def config(arch):
    return dataclasses.replace(get_config(arch, reduced=True),
                               dtype="float32")


@functools.lru_cache(maxsize=None)
def start(arch):
    """JAX's params, a batch and a mid-training AdamW state (f32), as
    numpy trees."""
    cfg = config(arch)
    rng = np.random.default_rng(0)
    params = jax.tree.map(np.asarray, jzoo.init(jax.random.PRNGKey(0), cfg))
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S + 1))
             .astype(np.int32)}
    extra = {"vlm": ("patches", cfg.prefix_tokens),
             "audio": ("frames", cfg.enc_seq)}.get(cfg.family)
    if extra:
        batch[extra[0]] = (0.02 * rng.standard_normal(
            (B, extra[1], cfg.d_model))).astype(np.float32)
    opt = {"m": jax.tree.map(lambda a: (0.01 * rng.standard_normal(a.shape))
                             .astype(np.float32), params),
           "v": jax.tree.map(lambda a: (1e-4 * rng.random(a.shape) + 1e-6)
                             .astype(np.float32), params),
           "step": np.int32(STEP - 1)}
    return cfg, params, batch, opt


def port(arch):
    cfg, params, batch, opt = start(arch)
    return (cfg, from_numpy(params, "cpu"),
            {k: torch.from_numpy(v) for k, v in batch.items()},
            from_numpy(opt, "cpu"))


def port_grads(cfg, params, batch):
    return tree.unflatten(params, psteps.loss_and_grads(cfg, params,
                                                        batch)[2])


@pytest.mark.parametrize("arch", FAMILIES)
def test_grads_match_jax(arch):
    cfg, params, batch, _ = start(arch)
    jg = jax.jit(jax.grad(lambda p, b: jzoo.loss_fn(cfg, p, b)[0]))(
        params, batch)
    _, pp, pb, _ = port(arch)
    trees_close(port_grads(cfg, pp, pb), jg, 1e-4)


@pytest.mark.parametrize("arch,microbatches,codec", [
    *((a, 1, None) for a in FAMILIES),
    *((a, 2, "int8") for a in FAMILIES),
    ("olmo-1b", 2, None), ("olmo-1b", 1, "int8")])
def test_train_step_matches_jax(arch, microbatches, codec):
    cfg, params, batch, opt = start(arch)
    if codec:
        opt = {**opt, "ef": jax.tree.map(np.asarray,
                                         jcompress.init_error_feedback(
                                             params))}
    jstep = jax.jit(jsteps.make_train_step(
        cfg, jadamw.AdamWConfig(state_dtype="float32"),
        microbatches=microbatches,
        compressor=jcompress.make_compressor(codec) if codec else None))
    jp, jst, jm = jstep(params, opt, batch, jnp.int32(STEP))

    _, pp, pb, pst = port(arch)
    if codec:
        pst["ef"] = pcompress.init_error_feedback(pp)
    pstep = psteps.make_train_step(
        cfg, padamw.AdamWConfig(state_dtype="float32"),
        microbatches=microbatches,
        compressor=pcompress.make_compressor(codec) if codec else None)
    pp, pst, pm = pstep(pp, pst, pb, STEP)

    rel(pm["loss"], jm["loss"], 1e-5)
    close(pm["aux"], jm["aux"], 1e-5)
    assert float(pm["lr_scale"]) == float(jm["lr_scale"]) == 1.0
    assert int(pst["step"]) == int(jst["step"]) == STEP
    if not codec:
        rel(pm["grad_norm"], jm["grad_norm"], 1e-5)
        trees_close(pp, jp, 1e-5)
        for key in ("m", "v"):
            trees_close(pst[key], jst[key], 1e-5)
        return
    ties = int8_ties(pst, jst, opt["m"])
    for got, want in ((pp, jp), *((pst[k], jst[k]) for k in ("m", "v",
                                                             "ef"))):
        for path, g, w, tie in zip(tree.paths(got), tree.leaves(got),
                                   jax.tree.leaves(want), ties):
            try:
                close(g.masked_fill(torch.from_numpy(tie), 0),
                      np.where(tie, 0, np.asarray(w)), 1e-5)
            except AssertionError as e:
                raise AssertionError(f"{path}: {e}") from None
    rel(pm["grad_norm"], jm["grad_norm"], 1e-5)


@pytest.mark.parametrize("arch", ["olmo-1b", "whisper-large-v3"])
def test_remat_on_and_off_give_equal_grads(arch):
    cfg, params, batch, _ = port(arch)
    on = port_grads(dataclasses.replace(cfg, remat=True), params, batch)
    off = port_grads(dataclasses.replace(cfg, remat=False), params, batch)
    for a, b in zip(tree.leaves(on), tree.leaves(off)):
        assert torch.equal(a, b)


def test_flash_attention_fn_cpu_grads_equal_plain_autograd():
    g = torch.Generator().manual_seed(0)
    leaves = [torch.randn(s, generator=g).requires_grad_()
              for s in ((2, 8, 96, 16), (2, 2, 96, 16), (2, 2, 96, 16))]
    do = torch.randn((2, 8, 96, 16), generator=g)
    for causal in (True, False):
        out = flash_ops.FlashAttentionFn.apply(*leaves, causal)
        assert out.grad_fn is not None
        got = torch.autograd.grad(out, leaves, do)
        want = torch.autograd.grad(
            flash_ops.attention_ref(*leaves, causal), leaves, do)
        for x, y in zip(got, want):
            torch.testing.assert_close(x, y, rtol=0, atol=1e-5)


@pytest.mark.parametrize("arch", ["olmo-1b", "whisper-large-v3",
                                  "mamba2-2.7b", "paligemma-3b"])
@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_calls_the_kernels_train_launches_counts(
        arch, microbatches, monkeypatch):
    """On the CPU the wrappers run their plain versions through the same
    wiring: one step calls flash_attention's forward, its backward and
    ssd_chunk and its backward as often as the card would launch them
    (each backward call launches ``BWD_PASSES``' or ``SSD_BWD_PASSES``'
    kernels)."""
    calls = {"flash_attention": 0, "flash_attention_bwd": 0,
             "ssd_chunk": 0, "ssd_chunk_bwd": 0}

    def counted(name, fn, launches=1):
        def call(*args, **kw):
            calls[name] += launches
            return fn(*args, **kw)
        return call
    monkeypatch.setattr(pattn, "flash_attention",
                        counted("flash_attention", pattn.flash_attention))
    monkeypatch.setattr(flash_ops, "flash_attention_backward",
                        counted("flash_attention_bwd",
                                flash_ops.flash_attention_backward,
                                len(flash_ops.BWD_PASSES)))
    monkeypatch.setattr(pssm, "ssd_chunk",
                        counted("ssd_chunk", pssm.ssd_chunk))
    monkeypatch.setattr(ssd_ops, "ssd_chunk_backward",
                        counted("ssd_chunk_bwd", ssd_ops.ssd_chunk_backward,
                                len(ssd_ops.SSD_BWD_PASSES)))
    cfg, params, batch, opt = port(arch)
    step = psteps.make_train_step(cfg, padamw.AdamWConfig(
        state_dtype="float32"), microbatches=microbatches)
    step(params, opt, batch, STEP)
    assert calls == pzoo.train_launches(cfg, microbatches)
    assert cfg.remat
