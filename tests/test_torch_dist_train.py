"""The LM trainer under a mesh on the CPU: a (2, 2) ("data", "model") mesh
over 4 gloo ranks, DTensor params and AdamW state laid out by
``param_shardings``, 3 steps of ``lm.steps.make_train_step(...,
param_shardings=)`` on reduced configs in float32 from JAX's params and a
mid-training AdamW state (step 1000, ``lr_scale`` = 1, as
``tests/test_torch_train.py``): olmo-1b (dense, the flash seam),
phi3-medium-14b (4 query heads over 2 model ranks, its 1 KV head
replicated), mamba2-2.7b (the SSD seam), llama4-maverick-400b (MoE,
experts over ``model``), and olmo-1b with int8 compression.  Losses and
grad norms within 1e-5 (relative) of the port's mesh-free step and of
JAX's mesh-free ``make_train_step`` (JAX's own trainer needs an
Explicit-axis mesh, which this jax refuses); the params after 3 steps
within 1e-5 · max|p| of the mesh-free port's.  With int8 compression an
element's code may flip at a rounding tie: step by step, each gradient
(derived from each run's own m) is within the limit of the mesh-free
run's or exactly one quantization step off it at few elements, as
``test_torch_train.py::int8_ties`` holds the port against JAX, and
params, m, v and the error feedback are off only at those elements.

Checkpoints: the olmo-1b state saved under (2, 2) restores bit-equal
under (4, 1) and without a mesh; a JAX checkpoint restores under (2, 2).
(The trainer's CLI over gloo is in ``test_torch_dist.py``.)

Every run is a fresh interpreter: the mesh ranks, and one spawned process
for JAX's inputs and checkpoint, the port's mesh-free runs and JAX's; the
test process only compares, so the torch and JAX state that earlier
tests leave in a shared worker process cannot reach either side."""
import dataclasses
import pickle

import numpy as np
import pytest
import torch

from test_torch_dist import dump, init_rank, spawn

from repro_torch import tree

torch.set_num_threads(1)
B, S, STEPS, STEP0 = 4, 32, 3, 1000
# (name, arch, microbatches, codec)
CASES = (("olmo-1b", "olmo-1b", 1, None),
         ("phi3-medium-14b", "phi3-medium-14b", 2, None),
         ("mamba2-2.7b", "mamba2-2.7b", 1, None),
         ("llama4-maverick-400b", "llama4-maverick-400b-a17b", 2, None),
         ("olmo-1b-int8", "olmo-1b", 2, "int8"))


def f32(arch, pkg):
    mod = __import__(f"{pkg}.configs", fromlist=["get_config"])
    return dataclasses.replace(mod.get_config(arch, reduced=True),
                               dtype="float32")


def start(arch, codec):
    """JAX's params, 3 batches and a mid-training AdamW state (numpy)."""
    import jax
    from repro.dist import compress as jcompress
    from repro.lm import model_zoo as jzoo
    cfg = f32(arch, "repro")
    rng = np.random.default_rng(0)
    params = jax.tree.map(np.asarray, jzoo.init(jax.random.PRNGKey(0), cfg))
    batches = [rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
               for _ in range(STEPS)]
    opt = {"m": jax.tree.map(lambda a: (0.01 * rng.standard_normal(a.shape))
                             .astype(np.float32), params),
           "v": jax.tree.map(lambda a: (1e-4 * rng.random(a.shape) + 1e-6)
                             .astype(np.float32), params),
           "step": np.int32(STEP0 - 1)}
    if codec:
        opt["ef"] = jax.tree.map(np.asarray,
                                 jcompress.init_error_feedback(params))
    return params, batches, opt


def run_port(arch, micro, codec, params, opt, batches, mesh=None):
    """3 port train steps (under ``mesh`` if given) -> (losses, grad
    norms, the final params and opt state, whole, as numpy trees, the
    live trees, and with a codec each step's whole m and error
    feedback)."""
    from repro_torch.dist import compress as pcompress
    from repro_torch.dist import sharding as shd
    from repro_torch.lm import steps as psteps
    from repro_torch.lm.params import from_numpy
    from repro_torch.optim import adamw
    cfg = f32(arch, "repro_torch")
    params, opt = from_numpy(params, "cpu"), from_numpy(opt, "cpu")
    p_sh = None
    if mesh is not None:
        p_sh = shd.param_shardings(params, mesh, cfg.moe_shard)
        params = shd.distribute(params, p_sh)
        opt = shd.distribute(opt, shd.param_shardings(opt, mesh,
                                                      cfg.moe_shard))
    step = psteps.make_train_step(
        cfg, adamw.AdamWConfig(state_dtype="float32"), microbatches=micro,
        compressor=pcompress.make_compressor(codec) if codec else None,
        param_shardings=p_sh)
    whole = lambda t: tree.map(                               # noqa: E731
        lambda x: shd.whole(x).numpy().copy(), t)
    losses, norms, trace = [], [], []
    for i, b in enumerate(batches):
        params, opt, m = step(params, opt, {"tokens": torch.from_numpy(b)},
                              STEP0 + i)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        if codec:
            trace.append(whole({"m": opt["m"], "ef": opt["ef"]}))
    return (losses, norms, whole(params), whole(opt), (params, opt),
            trace)


def _train_rank(rank, n, store, out, data, ck):
    init_rank(rank, n, store)
    from repro_torch.dist import sharding as shd
    from repro_torch.launch.mesh import make_mesh
    with open(data, "rb") as f:
        inputs = pickle.load(f)
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    res = {}
    for name, arch, micro, codec in CASES:
        params, batches, opt = inputs[name]
        cfg = f32(arch, "repro_torch")
        with shd.use_mesh(mesh, sp=cfg.seq_shard_blocks,
                          profile=cfg.shard_profile):
            losses, norms, p, o, live, trace = run_port(
                arch, micro, codec, params, opt, batches, mesh)
        res[name] = {"losses": losses, "norms": norms}
        if rank == 0:
            with open(f"{out}.{name}.pkl", "wb") as f:
                pickle.dump((p, o, trace), f)
        if name == "olmo-1b":
            ckpt = _ckpt_rank(cfg, live, (p, o), ck)
            if rank == 0:
                with open(f"{out}.ckpt.pkl", "wb") as f:
                    pickle.dump(ckpt, f)
    if rank == 0:
        dump(out, res)


def _ckpt_rank(cfg, live, whole, ck):
    """Save under (2, 2), restore under (4, 1): every leaf bit-equal; a
    JAX checkpoint restored under (2, 2)."""
    from repro_torch.ckpt.manager import CheckpointManager
    from repro_torch.dist import sharding as shd
    from repro_torch.launch.mesh import make_mesh
    params, opt = live
    CheckpointManager(f"{ck}/port").save(7, params, opt, {"step": 7})
    out = {}
    for tag, root, shape in (("port_41", f"{ck}/port", (4, 1)),
                             ("jax_22", f"{ck}/jax", (2, 2))):
        mesh = make_mesh(shape, ("data", "model"), device="cpu")
        sh = {"params": shd.param_shardings(params, mesh, cfg.moe_shard),
              "opt": shd.param_shardings(opt, mesh, cfg.moe_shard)}
        step, p, o, _ = CheckpointManager(root).restore(params, opt, sh)
        placed = all(
            t.placements == s.placements for t, s in zip(
                tree.leaves((p, o)), tree.leaves((sh["params"],
                                                  sh["opt"]))))
        out[tag] = {"step": step, "placed": placed,
                    "leaves": [shd.whole(t).numpy().copy()
                               for t in tree.leaves((p, o))]}
    out["saved"] = tree.leaves(whole)
    return out


def _jax_run(arch, micro, codec, params, opt, batches):
    import jax
    import jax.numpy as jnp
    from repro.dist import compress as jcompress
    from repro.lm import steps as jsteps
    from repro.optim import adamw as jadamw
    step = jax.jit(jsteps.make_train_step(
        f32(arch, "repro"), jadamw.AdamWConfig(state_dtype="float32"),
        microbatches=micro,
        compressor=jcompress.make_compressor(codec) if codec else None))
    losses, norms = [], []
    for i, b in enumerate(batches):
        params, opt, m = step(params, opt, {"tokens": jnp.asarray(b)},
                              jnp.int32(STEP0 + i))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return losses, norms


def _free_run(rank, n, store, out, tmp):
    """In a spawned process of its own: JAX's inputs (``in.pkl``) and
    checkpoint, the port's mesh-free runs and JAX's, into ``free.pkl``.
    A fresh interpreter, as the mesh ranks are: nothing that earlier
    tests left in the test process (its torch and JAX state) reaches
    the runs that the mesh runs are held against."""
    import jax.numpy as jnp
    from repro.ckpt.manager import CheckpointManager as JaxManager
    torch.set_num_threads(1)
    inputs = {name: start(arch, codec) for name, arch, _, codec in CASES}
    with open(f"{tmp}/in.pkl", "wb") as f:
        pickle.dump(inputs, f)
    jp, _, jo = inputs["olmo-1b"]
    JaxManager(f"{tmp}/ck/jax").save(
        5, jax_tree(jp, jnp), jax_tree(jo, jnp), {"step": 5})
    res = {}
    for name, arch, micro, codec in CASES:
        params, batches, opt = inputs[name]
        free = run_port(arch, micro, codec, params, opt, batches)
        res[name] = dict(free=free[:4], trace=free[5],
                         jax=_jax_run(arch, micro, codec, params, opt,
                                      batches))
    with open(f"{tmp}/free.pkl", "wb") as f:
        pickle.dump(res, f)
    dump(out, {"cases": len(res)})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's mesh-free runs, JAX's and its inputs and checkpoint (one
    spawned process), then the mesh runs (4 spawned ranks) and the
    checkpoints; this process only compares."""
    tmp = tmp_path_factory.mktemp("train")
    (tmp / "free").mkdir()
    assert spawn(_free_run, 1, tmp / "free", str(tmp)) == {
        "cases": len(CASES)}
    with open(tmp / "in.pkl", "rb") as f:
        inputs = pickle.load(f)
    with open(tmp / "free.pkl", "rb") as f:
        free = pickle.load(f)
    mesh = spawn(_train_rank, 4, tmp, str(tmp / "in.pkl"),
                 str(tmp / "ck"))
    out = {}
    for name, *_ in CASES:
        with open(tmp / f"out.json.{name}.pkl", "rb") as f:
            got = pickle.load(f)
        out[name] = dict(mesh=mesh[name], got=got, **free[name])
    with open(tmp / "out.json.ckpt.pkl", "rb") as f:
        out["ckpt"] = pickle.load(f)
    out["ckpt_root"] = tmp / "ck"
    out["inputs"] = inputs
    return out


def jax_tree(t, jnp):
    import jax
    return jax.tree.map(jnp.asarray, t)


def rel_close(got, want, tol=1e-5):
    for g, w in zip(got, want):
        assert abs(g - w) <= tol * abs(w), (got, want)


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_mesh_losses_and_grad_norms(name, runs):
    r = runs[name]
    losses, norms = r["mesh"]["losses"], r["mesh"]["norms"]
    assert len(losses) == STEPS and np.all(np.isfinite(losses))
    rel_close(losses, r["free"][0])
    rel_close(norms, r["free"][1])
    rel_close(losses, r["jax"][0])
    rel_close(norms, r["jax"][1])


def int8_step_ties(got, want, m0, b1=0.9):
    """Per leaf, a bool mask of the elements where a code flipped at a
    rounding tie.  ``got`` / ``want``: each step's whole m and error
    feedback of the mesh run and the mesh-free one; a step's compressed
    gradient is derived from its run's own m before and after it (AdamW's
    m = b1·m + (1 - b1)·g).  At each step the gradients agree within the
    limit or are a whole number of that step's quantization steps apart
    (a flip, or the next step's codes giving one back, two where the
    scale halved), at few elements; the error feedback then differs by
    minus the flips summed so far (it carries what the codes dropped), at
    most one step, and agrees elsewhere."""
    union = [np.zeros(a.shape, bool) for a in tree.leaves(m0)]
    flips = [np.zeros(a.shape, np.float32) for a in tree.leaves(m0)]
    prev_g = prev_w = tree.leaves(m0)
    for g_step, w_step in zip(got, want):
        leaves = zip(tree.leaves(g_step["m"]), tree.leaves(w_step["m"]),
                     prev_g, prev_w, tree.leaves(g_step["ef"]),
                     tree.leaves(w_step["ef"]), union, flips)
        for mg, mw, og, ow, eg, ew, mask, flip in leaves:
            d = ((mg - b1 * og.astype(np.float32))
                 - (mw - b1 * ow.astype(np.float32))) / (1 - b1)
            ef_lim = 1e-5 * max(1.0, float(np.abs(ew).max()))
            # a flip shows in the gradient, or (smaller than the m limit)
            # in the error feedback's change this step
            tie = ((np.abs(d) > 1e-5 * max(1.0, float(np.abs(mw).max()))
                    / (1 - b1))
                   | (np.abs(eg - ew + flip) > ef_lim))
            step = np.abs(mw - b1 * ow.astype(np.float32)).max() / (
                1 - b1) / 127
            codes = np.abs(d)[tie] / step
            assert np.allclose(codes, np.maximum(np.round(codes), 1),
                               rtol=1e-2)
            assert tie.sum() <= max(1, 2 * 1e-4 * 127 * tie.size)
            flip += np.where(tie, d, 0)
            np.testing.assert_allclose(eg - ew, -flip, rtol=0, atol=ef_lim)
            assert np.abs(flip).max() <= 1.01 * step + ef_lim
            mask |= tie
        prev_g = tree.leaves(g_step["m"])
        prev_w = tree.leaves(w_step["m"])
    return union


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_mesh_params_after_three_steps(name, runs):
    """Params, m and v (and the error feedback) of the mesh run against
    the mesh-free port's, each within 1e-5 · max(1, max|·|); with int8
    compression except at the elements ``int8_step_ties`` admits."""
    r = runs[name]
    codec = [c for c in CASES if c[0] == name][0][3]
    (gp, go, g_trace), fp, fo = r["got"], r["free"][2], r["free"][3]
    keys = ("m", "v") + (("ef",) if codec else ())
    n = len(tree.leaves(fp))
    if codec is None:
        ties = [np.zeros(a.shape, bool) for a in tree.leaves(fp)]
    else:
        ties = int8_step_ties(g_trace, r["trace"],
                              runs["inputs"][name][2]["m"])
        assert len(g_trace) == len(r["trace"]) == STEPS
    for i, (g, w) in enumerate(zip(
            tree.leaves((gp, *(go[k] for k in keys))),
            tree.leaves((fp, *(fo[k] for k in keys))))):
        off = np.abs(g - w) > 1e-5 * max(1.0, float(np.abs(w).max()))
        assert not (off & ~ties[i % n]).any(), float(
            np.abs(g - w)[~ties[i % n]].max())


def test_checkpoint_crosses_meshes(runs):
    """Written under (2, 2): restored under (4, 1) and without a mesh,
    every leaf bit-equal to what was saved; a JAX checkpoint under
    (2, 2) equal to the arrays JAX saved."""
    from repro_torch.ckpt.manager import CheckpointManager
    ck = runs["ckpt"]
    saved = ck["saved"]
    port41 = ck["port_41"]
    assert port41["step"] == 7 and port41["placed"]
    assert len(port41["leaves"]) == len(saved)
    for a, b in zip(port41["leaves"], saved):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    like = tree.map(torch.from_numpy, runs["olmo-1b"]["got"][:2])
    step, p, o, ds = CheckpointManager(
        str(runs["ckpt_root"] / "port")).restore(*like)
    assert (step, ds) == (7, {"step": 7})
    for t, b in zip(tree.leaves((p, o)), saved):
        assert np.array_equal(t.numpy(), b)
    jax22 = ck["jax_22"]
    jp, _, jo = runs["inputs"]["olmo-1b"]
    assert jax22["step"] == 5 and jax22["placed"]
    want = [np.asarray(a) for a in tree.leaves((jp, jo))]
    assert len(jax22["leaves"]) == len(want)
    for a, b in zip(jax22["leaves"], want):
        assert np.array_equal(a, b)
