"""The port's LM building blocks (``repro_torch.{configs,lm.config,nn}``)
against the JAX package on the CPU: the ten config copies, the init tree,
the attention route, and each ``nn`` function in float32 within
1e-5 · max(1, max|ref|) on the same numpy inputs and the same weights
(JAX's init carried across).  MoE routing indices and slots, drops at
capacity included, are exactly equal; kv_quant int8 codes within 1."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip(
    "repro.dist", reason="repro.dist (sharding subsystem) not present")

from repro import configs as jcfgs
from repro.lm import losses as jlosses
from repro.lm import model_zoo as jzoo
from repro.nn import attention as jattn
from repro.nn import layers as jnl
from repro.nn import moe as jmoe
from repro.nn import rglru as jrg
from repro.nn import ssm as jssm
from repro_torch import configs as pcfgs
from repro_torch.lm import losses as plosses
from repro_torch.lm import model_zoo as pzoo
from repro_torch.lm.params import from_numpy
from repro_torch.nn import attention as pattn
from repro_torch.nn import layers as pnl
from repro_torch.nn import moe as pmoe
from repro_torch.nn import rglru as prg
from repro_torch.nn import ssm as pssm

torch.set_num_threads(1)
TOL = 1e-5
KEY = jax.random.PRNGKey(0)


def carry(tree):
    return from_numpy(jax.tree.map(np.asarray, tree), device="cpu")


def both(a, dtype=np.float32):
    """numpy array -> (jnp array, torch tensor) of the same values."""
    a = np.asarray(a, dtype)
    return jnp.asarray(a), torch.from_numpy(a.copy())


def close(got, want, tol=TOL):
    got = got.detach().float().numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert got.shape == want.shape
    err = float(np.abs(got - want).max()) if want.size else 0.0
    lim = tol * max(1.0, float(np.abs(want).max()) if want.size else 1.0)
    assert err <= lim, f"max|Δ| {err:.3g} > {lim:.3g}"


def J(fn, *args):
    """``fn`` on JAX arrays, jitted (one compile instead of one per
    primitive); its static arguments are bound in ``fn``."""
    return jax.jit(fn)(*args)


def jitter(tree, rng, scale=0.1):
    """JAX params with every zero/one vector (biases, norm scales)
    replaced by random values, so those terms are exercised."""
    def f(x):
        x = np.asarray(x)
        if x.ndim == 1:
            return jnp.asarray(x + scale * rng.standard_normal(x.shape)
                               .astype(x.dtype))
        return jnp.asarray(x)
    return jax.tree.map(f, tree)


# ---- configs ------------------------------------------------------------------


@pytest.mark.parametrize("arch", jcfgs.ARCH_IDS)
def test_config_copies_equal_jax(arch):
    for reduced in (False, True):
        want = jcfgs.get_config(arch, reduced=reduced)
        got = pcfgs.get_config(arch, reduced=reduced)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.param_counts() == want.param_counts()
        assert [got.mixer_of(i) for i in range(got.n_layers)] == \
            [want.mixer_of(i) for i in range(want.n_layers)]
        assert [got.ffn_of(i) for i in range(got.n_layers)] == \
            [want.ffn_of(i) for i in range(want.n_layers)]


def test_registry_equal_jax():
    assert pcfgs.ARCH_IDS == jcfgs.ARCH_IDS
    assert {k: dataclasses.asdict(v) for k, v in pcfgs.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jcfgs.SHAPES.items()}
    assert pcfgs.SUBQUADRATIC == jcfgs.SUBQUADRATIC
    assert pcfgs.cells() == jcfgs.cells()


def _layout(tree):
    return jax.tree_util.tree_structure(
        jax.tree.map(lambda x: 0, tree)), jax.tree.leaves(tree)


@pytest.mark.parametrize("arch", jcfgs.ARCH_IDS)
def test_init_tree_has_jax_keys_shapes_dtypes(arch):
    for dtype in ("bfloat16", "float32"):
        cfg = dataclasses.replace(jcfgs.get_config(arch, reduced=True),
                                  dtype=dtype)
        want = jax.eval_shape(lambda: jzoo.init(KEY, cfg))
        got = pzoo.init(torch.Generator().manual_seed(0), cfg, device="cpu")
        (ws, wl), (gs, gl) = _layout(want), _layout(got)
        assert gs == ws
        assert [tuple(t.shape) for t in gl] == [tuple(s.shape) for s in wl]
        assert [str(t.dtype).replace("torch.", "") for t in gl] == \
            [str(s.dtype) for s in wl]


def test_init_is_seeded():
    cfg = pcfgs.get_config("olmo-1b", reduced=True)
    a, b, c = (pzoo.init(torch.Generator().manual_seed(s), cfg,
                         device="cpu") for s in (0, 0, 1))
    assert torch.equal(a["embed"], b["embed"])
    assert not torch.equal(a["embed"], c["embed"])


# ---- layers -------------------------------------------------------------------


def test_norms_rope_mlp():
    rng = np.random.default_rng(0)
    xj, xp = both(rng.standard_normal((2, 6, 4, 16)))
    sj, sp = both(0.1 * rng.standard_normal(16))
    bj, bp = both(0.1 * rng.standard_normal(16))
    close(pnl.rmsnorm(xp, sp), jnl.rmsnorm(xj, sj))
    close(pnl.np_layernorm(xp), jnl.np_layernorm(xj))
    close(pnl.layernorm(xp, sp, bp), jnl.layernorm(xj, sj, bj))
    pos = rng.integers(0, 500, (2, 6))
    close(pnl.rope(xp, torch.from_numpy(pos), 1e4),
          jnl.rope(xj, jnp.asarray(pos), 1e4))
    # the casts: norms and RoPE compute in f32, return the input dtype
    xb = xp.bfloat16()
    for y in (pnl.rmsnorm(xb, sp), pnl.np_layernorm(xb),
              pnl.layernorm(xb, sp, bp), pnl.rope(xb, torch.from_numpy(pos))):
        assert y.dtype == torch.bfloat16
    for act in ("swiglu", "geglu", "gelu"):
        jp = jnl.mlp_params(KEY, 16, 24, act, jnp.float32)
        close(pnl.mlp_apply(carry(jp), xp, act), jnl.mlp_apply(jp, xj, act))
        assert pnl.mlp_flops(16, 24, act) == jnl.mlp_flops(16, 24, act)


def test_cross_entropy():
    rng = np.random.default_rng(1)
    lj, lp = both(3 * rng.standard_normal((2, 7, 50)))
    lab = rng.integers(0, 50, (2, 7))
    mj, mp = both(rng.integers(0, 2, (2, 7)))
    close(plosses.cross_entropy(lp, torch.from_numpy(lab)),
          jlosses.cross_entropy(lj, jnp.asarray(lab)))
    close(plosses.cross_entropy(lp, torch.from_numpy(lab), mp),
          jlosses.cross_entropy(lj, jnp.asarray(lab), mj))


# ---- attention ----------------------------------------------------------------


@pytest.mark.parametrize("kind,head_dim,prefix,softcap,route", [
    ("causal", 128, 0, 0.0, "flash"),
    ("causal", 256, 0, 0.0, "flash"),
    ("causal", 257, 0, 0.0, "flash"),
    ("causal", 128, 16, 0.0, "plain"),
    ("causal", 128, 0, 30.0, "plain"),
    ("bidir", 64, 0, 0.0, "flash"),
    ("bidir", 512, 0, 0.0, "flash"),
    ("local", 128, 0, 0.0, "plain"),
    ("cross", 64, 0, 0.0, "plain"),
    ("decode", 128, 0, 0.0, "plain"),
])
def test_attention_route(kind, head_dim, prefix, softcap, route):
    assert pattn.attention_route(kind, head_dim, prefix, softcap) == route


@pytest.fixture
def flash_calls(monkeypatch):
    """The ``causal`` argument of every call the attention module makes to
    the flash_attention wrapper (which then runs as it would)."""
    calls, real = [], pattn.flash_attention

    def spy(q, k, v, causal=True):
        calls.append(causal)
        return real(q, k, v, causal=causal)
    monkeypatch.setattr(pattn, "flash_attention", spy)
    return calls


def _attn(rng, d=64, h=4, hkv=2, hd=16, bias=True):
    jp = jitter(jattn.attn_params(KEY, d, h, hkv, hd, bias, jnp.float32), rng)
    return jp, carry(jp)


@pytest.mark.parametrize("case", ["flash", "flash_mha", "prefix", "softcap",
                                  "flash_chunked", "softcap_chunked",
                                  "no_rope"])
def test_causal_attention(case, monkeypatch, flash_calls):
    rng = np.random.default_rng(2)
    hkv = 4 if case == "flash_mha" else 2
    jp, pp = _attn(rng, hkv=hkv)
    s = 32
    xj, xp = both(rng.standard_normal((2, s, 64)))
    pos = np.tile(np.arange(s), (2, 1))
    kw = dict(softcap=30.0 if "softcap" in case else 0.0,
              prefix_len=8 if case == "prefix" else 0,
              use_rope=case != "no_rope")
    if case.endswith("chunked"):      # JAX chunks the queries above this
        monkeypatch.setattr(jattn, "CHUNK_Q_ABOVE", 8)
        monkeypatch.setattr(pattn, "CHUNK_Q_ABOVE", 8)
    want = J(lambda p, x: jattn.causal_attention(
        p, x, 4, hkv, 16, jnp.asarray(pos), 1e4, **kw), jp, xj)
    got = pattn.causal_attention(pp, xp, 4, hkv, 16, torch.from_numpy(pos),
                                 1e4, **kw)
    close(got, want)
    # the route's wiring: one kernel call, causal, where the route says
    route = pattn.attention_route("causal", 16, kw["prefix_len"],
                                  kw["softcap"])
    assert flash_calls == ([True] if route == "flash" else [])


def test_local_attention():
    rng = np.random.default_rng(3)
    jp, pp = _attn(rng)
    xj, xp = both(rng.standard_normal((2, 32, 64)))
    pos = np.tile(np.arange(32), (2, 1))
    for window in (8, 32, 64):
        close(pattn.local_attention(pp, xp, 4, 2, 16, torch.from_numpy(pos),
                                    1e4, window),
              J(lambda p, x: jattn.local_attention(
                  p, x, 4, 2, 16, jnp.asarray(pos), 1e4, window), jp, xj))


def test_bidir_and_cross_attention(flash_calls):
    rng = np.random.default_rng(4)
    jp, pp = _attn(rng)
    xj, xp = both(rng.standard_normal((2, 12, 64)))
    ej, ep = both(rng.standard_normal((2, 20, 64)))
    close(pattn.bidir_attention(pp, ep, 4, 2, 16),
          J(lambda p, e: jattn.bidir_attention(p, e, 4, 2, 16), jp, ej))
    assert flash_calls == [False]
    close(pattn.cross_attention(pp, xp, ep, 4, 2, 16),
          J(lambda p, x, e: jattn.cross_attention(p, x, e, 4, 2, 16), jp, xj,
            ej))
    kj, vj = jattn.cross_kv(jp, ej, 2, 16)
    kp, vp = pattn.cross_kv(pp, ep, 2, 16)
    close(kp, kj)
    close(vp, vj)
    close(pattn.decode_cross_attention(pp, xp[:, :1], kp, vp, 4, 2, 16),
          jattn.decode_cross_attention(jp, xj[:, :1], kj, vj, 4, 2, 16))


@pytest.mark.parametrize("case", ["plain", "window_ring", "kv_quant",
                                  "kv_quant_window", "softcap", "no_rope",
                                  "past_end"])
def test_decode_attention(case):
    rng = np.random.default_rng(5)
    jp, pp = _attn(rng)
    t = 6
    window = 6 if "window" in case else 0
    quant = case.startswith("kv_quant")
    steps = 10 if window else (8 if case == "past_end" else t)
    kw = dict(window=window, softcap=30.0 if case == "softcap" else 0.0,
              use_rope=case != "no_rope")
    shape = (2, t, 2, 16)
    if quant:
        jc = [jnp.zeros(shape, jnp.int8)] * 2 + [jnp.zeros(shape[:3])] * 2
    else:
        jc = [jnp.zeros(shape)] * 2
    pc = [torch.from_numpy(np.asarray(c).copy()) for c in jc]
    for pos in range(steps):
        xj, xp = both(rng.standard_normal((2, 1, 64)))
        if quant:
            out_j, *jc = jattn.decode_attention(
                jp, xj, jc[0], jc[1], jnp.int32(pos), 4, 2, 16, 1e4,
                k_scale=jc[2], v_scale=jc[3], **kw)
            out_p, *pc = pattn.decode_attention(
                pp, xp, pc[0], pc[1], pos, 4, 2, 16, 1e4, k_scale=pc[2],
                v_scale=pc[3], **kw)
            diffs = [int((a.int() - torch.from_numpy(np.asarray(b).astype(
                np.int32))).abs().max()) for a, b in zip(pc[:2], jc[:2])]
            assert max(diffs) <= 1                 # int8 codes within 1
            close(pc[2], jc[2])
            close(pc[3], jc[3])
            # a code one off moves the output by up to a step of its scale
            close(out_p, out_j, TOL if max(diffs) == 0 else 1e-2)
        else:
            out_j, *jc = jattn.decode_attention(
                jp, xj, jc[0], jc[1], jnp.int32(pos), 4, 2, 16, 1e4, **kw)
            out_p, *pc = pattn.decode_attention(
                pp, xp, pc[0], pc[1], pos, 4, 2, 16, 1e4, **kw)
            close(out_p, out_j)
            close(pc[0], jc[0])
            close(pc[1], jc[1])


def test_kv_quant_codes():
    rng = np.random.default_rng(6)
    kj, kp = both(rng.standard_normal((3, 1, 4, 32)))
    qj, sj = jattn._quantize_kv(kj)
    qp, sp = pattn._quantize_kv(kp)
    assert qp.dtype == torch.int8
    diff = np.abs(qp.numpy().astype(int) - np.asarray(qj).astype(int))
    assert diff.max() <= 1
    close(sp, sj)


# ---- SSD / RG-LRU -------------------------------------------------------------


@pytest.mark.parametrize("s,chunk", [(64, 16), (48, 16), (12, 16)])
def test_ssd_apply(s, chunk):
    rng = np.random.default_rng(7)
    jp = jitter(jssm.ssd_params(KEY, 32, 8, 4, 2, 16, jnp.float32), rng)
    jp = {**jp, "A_log": jnp.asarray(
        rng.uniform(-1, 1, jp["A_log"].shape).astype(np.float32))}
    uj, up = both(rng.standard_normal((2, s, 32)))
    close(pssm.ssd_apply(carry(jp), up, 8, 2, 16, chunk),
          J(lambda p, u: jssm.ssd_apply(p, u, 8, 2, 16, chunk), jp, uj))


def test_ssd_decode():
    rng = np.random.default_rng(8)
    jp = jitter(jssm.ssd_params(KEY, 32, 8, 4, 2, 16, jnp.float32), rng)
    pp = carry(jp)
    sj, sp = both(0.1 * rng.standard_normal((2, 4, 16, 8)))
    cj, cp = both(0.1 * rng.standard_normal((2, 3, 64 + 16)))
    for _ in range(4):
        uj, up = both(rng.standard_normal((2, 1, 32)))
        yj, sj, cj = jssm.ssd_decode(jp, uj, sj, cj, 8, 2, 16)
        yp, sp, cp = pssm.ssd_decode(pp, up, sp, cp, 8, 2, 16)
        close(yp, yj)
        close(sp, sj)
        close(cp, cj)


@pytest.mark.parametrize("s", [1, 7, 64])
def test_rglru_apply(s):
    rng = np.random.default_rng(9)
    jp = jrg.rglru_params(KEY, 32, 48, 4, jnp.float32)
    uj, up = both(rng.standard_normal((2, s, 32)))
    close(prg.rglru_apply(carry(jp), up), J(jrg.rglru_apply, jp, uj))


def test_rglru_decode_and_init():
    rng = np.random.default_rng(10)
    jp = jrg.rglru_params(KEY, 32, 48, 4, jnp.float32)
    pp = carry(jp)
    sj, sp = both(0.1 * rng.standard_normal((2, 48)))
    cj, cp = both(0.1 * rng.standard_normal((2, 3, 48)))
    for _ in range(4):
        uj, up = both(rng.standard_normal((2, 1, 32)))
        yj, sj, cj = jrg.rglru_decode(jp, uj, sj, cj)
        yp, sp, cp = prg.rglru_decode(pp, up, sp, cp)
        close(yp, yj)
        close(sp, sj)
        close(cp, cj)
    own = prg.rglru_params(torch.Generator().manual_seed(0), 32, 48, 4,
                           torch.float32, "cpu")
    close(own["lam"], jp["lam"])


# ---- MoE ----------------------------------------------------------------------


def _moe(rng, n_experts=4, act="swiglu", shared=False):
    jp = jmoe.moe_params(KEY, 32, 48, n_experts, act, jnp.float32,
                         shared=shared)
    return jp, carry(jp)


def _jax_slots(idx_k, n_experts, cap):
    """moe.py's first-come rank and drop row, as moe_apply computes it."""
    n_tok, top_k = idx_k.shape
    onehot = jax.nn.one_hot(idx_k.reshape(-1), n_experts, dtype=jnp.int32)
    pos = jnp.cumsum(onehot, axis=0) - 1
    pos = jnp.take_along_axis(pos, idx_k.reshape(-1, 1), axis=1
                              ).reshape(n_tok, top_k)
    return jnp.where(pos < cap, pos, cap)


@pytest.mark.parametrize("top_k,cf", [(1, 1.25), (2, 1.25), (2, 0.5),
                                      (1, 0.3)])
def test_moe_routing_exact(top_k, cf):
    rng = np.random.default_rng(11)
    jp, pp = _moe(rng)
    xj, xp = both(rng.standard_normal((40, 32)))
    gj, ij, aj = jmoe._route(jp, xj, 4, top_k)
    gp, ip, ap = pmoe._route(pp, xp, 4, top_k)
    assert np.array_equal(ip.numpy(), np.asarray(ij))
    close(gp, gj)
    close(ap, aj)
    cap = pmoe.capacity(40, top_k, 4, cf)
    assert cap == max(int(40 * top_k / 4 * cf), 4)
    slots = pmoe._slots(ip, 4, cap)
    assert np.array_equal(slots.numpy(), np.asarray(_jax_slots(ij, 4, cap)))
    if cf < 1:
        assert int((slots == cap).sum()) > 0        # drops at capacity


def test_moe_top_k_ties_to_lower_index():
    gates = torch.tensor([[0.25, 0.25, 0.25, 0.25],
                          [0.1, 0.4, 0.1, 0.4]])
    p = {"router": torch.eye(4)}
    _, idx, _ = pmoe._route(p, torch.log(gates), 4, 2)
    _, jidx = jax.lax.top_k(jnp.asarray(gates.numpy()), 2)
    assert idx.tolist() == [[0, 1], [1, 3]] == np.asarray(jidx).tolist()


@pytest.mark.parametrize("scheme,top_k,cf,act,shared", [
    ("scatter", 1, 1.25, "swiglu", True),
    ("scatter", 2, 1.25, "geglu", False),
    ("scatter", 2, 0.5, "swiglu", False),
    ("scatter", 1, 1.0, "gelu", False),
    ("dense", 2, 1.25, "swiglu", True),
    ("dense", 1, 1.25, "gelu", False),
])
def test_moe_apply(scheme, top_k, cf, act, shared):
    rng = np.random.default_rng(12)
    jp, pp = _moe(rng, act=act, shared=shared)
    xj, xp = both(rng.standard_normal((2, 20, 32)))
    yj, aj = J(lambda p, x: jmoe.moe_apply(p, x, 4, top_k, act, cf, scheme),
               jp, xj)
    yp, ap = pmoe.moe_apply(pp, xp, 4, top_k, act, cf, scheme)
    close(yp, yj)
    close(ap, aj)
