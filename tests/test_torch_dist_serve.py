"""LM serving under a mesh on the CPU (``launch.serve.serve_lm`` with
``local_mesh()``): 4 gloo ranks, a (1, 4) ("data", "model") mesh,
tensor-parallel decode with the params laid out by ``param_shardings``
and the caches by ``cache_shardings`` as DTensors, on reduced olmo-1b
(dense), mamba2-2.7b (the SSD's state and conv caches),
recurrentgemma-2b (RG-LRU state and conv, local attention's ring
cache), whisper-large-v3 (the encoder's cross K/V built by
``make_cache`` under the mesh) and llama4-maverick (MoE, the expert FFN
split) in float32: the tokens equal the mesh-free ``serve_lm``'s and
every generated step's logits are within 1e-5 of them; for the four
non-MoE configs the tokens also equal JAX's ``serve_lm`` loop (JAX's
mesh fails on the MoE archs under Explicit axes, ROADMAP queue 3, so
MoE is held against the mesh-free port only).  phi3-medium's KV heads
do not divide the model axis (replicated, as ``cache_shardings`` leaves
them) and serve alike.  The CLI in 4 ranks prints on rank 0 only; a
one-rank mesh handed to ``serve_lm`` gives the mesh-free bits."""
import argparse
import contextlib
import dataclasses
import io

import jax
import numpy as np
import pytest
import torch

from test_torch_dist import dump, init_rank, spawn

from repro_torch.launch import serve as pserve

torch.set_num_threads(1)
ARCHS = ("olmo-1b", "mamba2-2.7b", "recurrentgemma-2b", "whisper-large-v3",
         "llama4-maverick-400b-a17b", "phi3-medium-14b")
MOE = ("llama4-maverick-400b-a17b",)
RUN = dict(batch=2, prompt_len=8, gen=6, cache_len=16)
TOL = 1e-5


def f32(arch, pkg="repro_torch"):
    mod = __import__(f"{pkg}.configs", fromlist=["get_config"])
    return dataclasses.replace(mod.get_config(arch, reduced=True),
                               dtype="float32")


def serve(arch, mesh=None):
    """-> (tokens, each generated step's logits) of the port's serve_lm
    on the reduced config in float32."""
    cfg = f32(arch)
    get = pserve.get_config
    pserve.get_config = lambda a, reduced: cfg
    try:
        logits = []
        gen = pserve.serve_lm(argparse.Namespace(
            arch=arch, reduced=True, device="cpu", **RUN), mesh=mesh,
            logits=logits)
    finally:
        pserve.get_config = get
    return gen, [t.float().numpy() for t in logits]


def _serve_rank(rank, n, store, out):
    init_rank(rank, n, store)
    res = {}
    with contextlib.redirect_stdout(io.StringIO()):
        for arch in ARCHS:
            gen, logits = serve(arch)
            res[arch] = (gen.tolist(), [t.tolist() for t in logits])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli = pserve.main(["--arch", "olmo-1b", "--reduced", "--device",
                           "cpu", "--batch", "2", "--prompt-len", "4",
                           "--gen", "2", "--cache-len", "8"])
    gathered = [None] * n
    torch.distributed.all_gather_object(
        gathered, (buf.getvalue().splitlines(), cli.tolist()))
    if rank == 0:
        dump(out, {"runs": res, "cli": gathered})


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    return spawn(_serve_rank, 4, tmp_path_factory.mktemp("serve"))


@pytest.fixture(scope="module")
def free_runs():
    return {arch: serve(arch) for arch in ARCHS}


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_serving_equals_mesh_free(arch, mesh_runs, free_runs):
    gen, logits = mesh_runs["runs"][arch]
    want_gen, want_logits = free_runs[arch]
    assert np.array_equal(np.array(gen), want_gen)
    assert len(logits) == len(want_logits) == RUN["gen"]
    err = max(float(np.abs(np.array(g) - w).max())
              for g, w in zip(logits, want_logits))
    print(f"{arch}: max |Δ logits| under the (1, 4) mesh {err:.3g}")
    assert err <= TOL


@pytest.mark.parametrize("arch", [a for a in ARCHS if a not in MOE])
def test_mesh_serving_equals_jax(arch, mesh_runs):
    """JAX's serve_lm loop on the weights the ranks served (the port's
    seeded params, carried to JAX leaf for leaf)."""
    from repro.lm import model_zoo as jzoo
    from repro_torch import tree
    from repro_torch.lm import model_zoo as pzoo
    from test_torch_lm_serve import jax_greedy
    cfg = f32(arch, "repro")
    params = pzoo.init(torch.Generator().manual_seed(0), f32(arch), "cpu")
    shapes = jax.eval_shape(lambda k: jzoo.init(k, cfg),
                            jax.random.PRNGKey(0))
    jparams = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(shapes),
        [jax.numpy.asarray(t.numpy()) for t in tree.leaves(params)])
    want = jax_greedy(cfg, jparams, **RUN)
    assert np.array_equal(np.array(mesh_runs["runs"][arch][0]), want)


def test_cli_over_four_ranks_prints_on_rank_0(mesh_runs):
    (lines0, gen0), *others = mesh_runs["cli"]
    assert lines0[0].startswith("cpu: olmo-1b-smoke (2 layers, bfloat16, "
                                "mesh {'data': 1, 'model': 4} over 4 "
                                "devices)")
    assert np.array(gen0).shape == (2, 2)
    for lines, gen in others:
        assert lines == [] and gen == gen0


@pytest.mark.parametrize("arch", ["olmo-1b", "mamba2-2.7b"])
def test_one_rank_mesh_gives_the_mesh_free_bits(arch, free_runs):
    from repro_torch.launch.mesh import local_mesh, release_world
    try:
        gen, logits = serve(arch, local_mesh("cpu"))
    finally:
        release_world()
    want_gen, want_logits = free_runs[arch]
    assert np.array_equal(gen, want_gen)
    assert all(np.array_equal(g, w) for g, w in zip(logits, want_logits))
