"""The port's LM planning tools (``repro_torch.launch.{memmodel,memreport,
dryrun,roofline,hillclimb,report}``, ``repro_torch.HW``,
``lm.model_zoo.{input_specs,cache_specs}``) against the JAX package on
the CPU:

* ``input_specs`` / ``cache_specs``: the shapes and dtypes of JAX's
  ``ShapeDtypeStruct`` stand-ins, for the ten configs × four ``SHAPES``,
  as ``meta`` tensors;
* ``python -m repro_torch.launch.memreport --out`` (a fake world of 256
  and of 512 ranks) against ``python -m repro.launch.memreport --out``:
  every byte field of all 32 cells exactly equal on both meshes (JAX's
  ``fits_16GiB`` is the port's ``fits_hbm``, against one H100's 80 GB);
* ``model_flops``, ``build_rows``, ``to_markdown``, ``coverage``,
  ``merge`` and ``parse_override`` equal to JAX's on the same records.
  By design only the peaks (``repro_torch.HW`` is an H100's, JAX's
  ``repro.HW`` a TPU v5e's: ``roofline_frac`` scales by their ratio) and
  the lever wording differ;
* the dry run in a subprocess on a fake world of 4 ranks as a (2, 2)
  ("data", "model") mesh: reduced olmo-1b (dense), mamba2-2.7b (ssm),
  llama4 (moe) and whisper-large-v3 (audio) at a train, a prefill and a
  decode shape, each ``ok`` with collective bytes above 0 (the model axis
  splits their weights), and olmo-1b's train step's per-device flops × 4
  within 10 % of the same step's mesh-free count (the ratio printed),
  under torch 2.11's stricter DTensor view rule (the card's torch);
  ``DeviceTrace``'s counts on one product.

The JAX CLIs (``memreport``, and ``hillclimb`` for ``parse_override``:
both set ``XLA_FLAGS`` when imported) and the fake worlds run in
subprocesses, all started at once by one module fixture."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import HW
from repro_torch.configs import ARCH_IDS, SHAPES
from repro_torch.lm import model_zoo as pzoo

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 600
DRY_ARCHS = ("olmo-1b", "mamba2-2.7b", "llama4-maverick-400b-a17b",
             "whisper-large-v3")
# (name, seq_len, global batch, kind) of the dry run's CPU-sized cells
DRY_SHAPES = (("train_s", 64, 8, "train"), ("prefill_s", 64, 4, "prefill"),
              ("decode_s", 64, 4, "decode"))
OVERRIDES = ("seq_shard_blocks=False", "ssd_chunk=128", "capacity_factor=1.5",
             "moe_shard=tp", "remat=True", "dtype=float32", "x=1e-3")

# torch 2.11's DTensor (the card's) refuses a view that flattens a group
# of dims whose non-first dim is split, where later releases split it as a
# strided shard: the dry run is held to the stricter rule where this torch
# has the rule's class
STRICT_VIEWS = """
from torch.distributed.tensor._ops import _view_ops as V
if hasattr(V, "_ViewShardingPropagator"):
    _flatten = V._ViewShardingPropagator._analyze_flatten
    def _strict(self, cmd):
        for i, dim in enumerate(cmd.input_dims):
            split = self._find_plain_shard(dim)[0] is not None
            if i and self.strict_view and split:
                raise RuntimeError(f"a view flattens {cmd.input_dims} with a "
                                   f"non-first dim split (torch 2.11 refuses)")
        return _flatten(self, cmd)
    V._ViewShardingPropagator._analyze_flatten = _strict
"""
DRY_CODE = STRICT_VIEWS + """
import json, sys
from repro_torch.configs import ShapeSpec, get_config
from repro_torch.launch import dryrun
archs, shapes = json.loads(sys.argv[1]), json.loads(sys.argv[2])
out = sys.argv[3]
recs, ratio = [], {}
with dryrun.World(shape=(2, 2)) as world:
    for arch in archs:
        cfg = get_config(arch, reduced=True)
        for name, seq, batch, kind in shapes:
            rec = dryrun.run_cell(arch, ShapeSpec(name, seq, batch, kind),
                                  False, world.mesh, cfg=cfg)
            rec.pop("trace", None)
            recs.append(rec)
        if arch == "olmo-1b":
            sp = ShapeSpec(*shapes[0])
            free = dryrun.trace_step(cfg, sp, None)["flops"]
            meshed = dryrun.trace_step(cfg, sp, world.mesh)["flops"]
            ratio = {"per_device": meshed, "mesh_free": free,
                     "ratio": meshed * 4 / free}
    try:
        dryrun.make_mesh((2, 2), ("data", "model"), "cpu")
        refused = ""
    except RuntimeError as e:
        refused = str(e)
json.dump({"records": recs, "olmo_flops": ratio, "refused": refused},
          open(out, "w"))
"""
PARSE_CODE = """
import json, sys
from repro.launch.hillclimb import parse_override
print(json.dumps([parse_override(s) for s in json.loads(sys.argv[1])]))
"""


def _env():
    return {**os.environ, "PYTHONPATH": str(ROOT / "src"),
            "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1"}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every subprocess of this module, started together: JAX's and the
    port's memreport on both meshes, the dry run split over two
    processes, JAX's parse_override.  -> their outputs."""
    tmp = tmp_path_factory.mktemp("tools")
    procs = {}

    def start(key, argv):
        procs[key] = subprocess.Popen(
            [sys.executable] + argv, cwd=tmp, env=_env(), text=True,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE)

    for pkg in ("repro", "repro_torch"):
        for mp in (False, True):
            argv = ["-m", f"{pkg}.launch.memreport", "--out",
                    str(tmp / f"{pkg}_{mp}.json")]
            start(("memreport", pkg, mp), argv + ["--multi-pod"] * mp)
    for i, archs in enumerate((DRY_ARCHS[::2], DRY_ARCHS[1::2])):
        start(("dryrun", i), ["-c", DRY_CODE, json.dumps(archs),
                              json.dumps(DRY_SHAPES),
                              str(tmp / f"dry{i}.json")])
    start(("parse",), ["-c", PARSE_CODE, json.dumps(OVERRIDES)])
    out = {}
    try:
        for key, p in procs.items():
            stdout, stderr = p.communicate(timeout=TIMEOUT)
            assert p.returncode == 0, (key, stderr[-3000:])
            out[key] = stdout
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
    for pkg in ("repro", "repro_torch"):
        for mp in (False, True):
            with open(tmp / f"{pkg}_{mp}.json") as fh:
                out[("memreport", pkg, mp)] = json.load(fh)
    dry = {"records": [], "olmo_flops": None, "refused": []}
    for i in range(2):
        with open(tmp / f"dry{i}.json") as fh:
            part = json.load(fh)
        dry["records"] += part["records"]
        dry["olmo_flops"] = dry["olmo_flops"] or part["olmo_flops"]
        dry["refused"].append(part["refused"])
    out["dryrun"] = dry
    out["parse"] = json.loads(out[("parse",)])
    return out


# ---------------------------------------------------------------------------
# the stand-ins
# ---------------------------------------------------------------------------

def _dtype(x) -> str:
    return str(x.dtype).replace("torch.", "")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_and_cache_specs_equal_jax(arch):
    import jax
    from repro.configs import get_config as jget
    from repro.lm import model_zoo as jzoo
    from repro_torch import tree
    from repro_torch.configs import get_config
    jcfg, cfg = jget(arch), get_config(arch)
    for sp in SHAPES.values():
        want = jzoo.input_specs(jcfg, sp.seq_len, sp.global_batch, sp.kind)
        got = pzoo.input_specs(cfg, sp.seq_len, sp.global_batch, sp.kind)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].device.type == "meta"
            assert tuple(got[k].shape) == tuple(want[k].shape), (sp, k)
            assert _dtype(got[k]) == str(want[k].dtype), (sp, k)
        want = jax.tree_util.tree_leaves(
            jzoo.cache_specs(jcfg, sp.global_batch, sp.seq_len))
        got = tree.leaves(pzoo.cache_specs(cfg, sp.global_batch,
                                           sp.seq_len))
        assert all(t.device.type == "meta" for t in got)
        assert [(tuple(t.shape), _dtype(t)) for t in got] == \
            [(tuple(t.shape), str(t.dtype)) for t in want], sp


def test_meta_init_draws_nothing():
    from repro_torch import tree
    from repro_torch.configs import get_config
    cfg = get_config("olmo-1b")
    params = pzoo.init(None, cfg, "meta")
    leaves = tree.leaves(params)
    assert all(t.device.type == "meta" for t in leaves)
    assert sum(t.numel() for t in leaves) == cfg.param_counts()["total"]


# ---------------------------------------------------------------------------
# the memory report
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("multi_pod", [False, True],
                         ids=["16x16", "2x16x16"])
def test_memreport_bytes_equal_jax(multi_pod, runs):
    want = runs[("memreport", "repro", multi_pod)]
    got = runs[("memreport", "repro_torch", multi_pod)]
    assert len(want) == len(got) == 32
    for w, g in zip(want, got):
        assert (g["arch"], g["shape"]) == (w["arch"], w["shape"])
        assert sorted(g) == sorted(k if k != "fits_16GiB" else "fits_hbm"
                                   for k in w)
        for k, v in w.items():
            if k.endswith("_bytes") or k == "gib":
                assert g[k] == v, (w["arch"], w["shape"], k)
        assert g["fits_hbm"] == (g["total_bytes"] < HW["hbm_bytes"])


def test_memreport_names_the_card(runs):
    text = runs[("memreport", "repro_torch", False)]
    assert len(text) == 32
    assert HW["hbm_bytes"] == 80e9 and HW["peak_bf16_flops"] == 989e12


# ---------------------------------------------------------------------------
# roofline, report, hillclimb against JAX on hand-made records
# ---------------------------------------------------------------------------

def _records():
    """Dry-run records by hand: ok cells of every dominant term, a
    skipped and an error cell, on both meshes."""
    recs = []
    terms = ((3e-2, 1e-2, 1e-3), (1e-3, 5e-2, 2e-3), (1e-3, 2e-3, 9e-2))
    cells = [("olmo-1b", "train_4k"), ("mamba2-2.7b", "decode_32k"),
             ("qwen2-72b", "prefill_32k"), ("grok-1-314b", "train_4k"),
             ("whisper-large-v3", "decode_32k")]
    for i, (arch, shape) in enumerate(cells):
        c, m, k = terms[i % 3]
        for mp in (False, True):
            recs.append({
                "arch": arch, "shape": shape, "multi_pod": mp,
                "status": "ok", "chips": 512 if mp else 256,
                "hlo_flops_per_chip": 1.5e13 * (i + 1),
                "collective_bytes_per_chip": {
                    "all-gather": 3e9 + i, "all-reduce": 2e9,
                    "reduce-scatter": 1e9 * i, "total": 6e9 + i},
                "compute_s": c, "memory_s": m, "collective_s": k,
                "dominant": max((("compute_s", c), ("memory_s", m),
                                 ("collective_s", k)),
                                key=lambda t: t[1])[0]})
    recs.append({"arch": "gemma-7b", "shape": "long_500k",
                 "multi_pod": False, "status": "skipped",
                 "reason": "full-attention arch; 500k needs sub-quadratic "
                           "mixing (DESIGN.md §4)"})
    recs.append({"arch": "paligemma-3b", "shape": "train_4k",
                 "multi_pod": False, "status": "error",
                 "error": "RuntimeError: no sharding strategy for aten.x"})
    return recs


def test_model_flops_equal_jax():
    from repro.launch import roofline as jroof
    from repro_torch.launch import roofline as proof
    for arch in ARCH_IDS:
        for shape in SHAPES:
            assert proof.model_flops(arch, shape) == \
                jroof.model_flops(arch, shape)


@pytest.mark.parametrize("multi_pod", [False, True],
                         ids=["16x16", "2x16x16"])
def test_build_rows_and_markdown_equal_jax(multi_pod):
    """Equal but for the peaks (roofline_frac scales by JAX's TPU peak
    over the H100's) and the levers' wording, by design."""
    from repro import HW as JHW
    from repro.launch import roofline as jroof
    from repro_torch.launch import roofline as proof
    want = jroof.build_rows(_records(), multi_pod)
    got = proof.build_rows(_records(), multi_pod)
    assert len(got) == len(want) and got
    scale = JHW["peak_bf16_flops"] / HW["peak_bf16_flops"]
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            if k == "roofline_frac":
                assert g[k] == pytest.approx(w[k] * scale, rel=1e-12)
            elif k == "lever":
                assert "MXU" not in g[k]
            else:
                assert g[k] == w[k], k
    for rows in (got, want):
        for r in rows:
            if "lever" in r:
                r.update(lever="", roofline_frac=0.0)
    assert proof.to_markdown(got) == jroof.to_markdown(want)


def test_levers_name_the_cards_units():
    from repro_torch.launch import roofline as proof
    levers = {r["dominant"]: r["lever"]
              for r in proof.build_rows(_records())
              if "dominant" in r}
    assert "tensor-core" in levers["compute_s"]
    assert "NVLink" in levers["collective_s"]
    assert "HBM-bound" in levers["memory_s"]


@pytest.mark.parametrize("multi_pod", [False, True],
                         ids=["16x16", "2x16x16"])
def test_coverage_equals_jax(multi_pod):
    from repro.launch import report as jrep
    from repro_torch.launch import report as prep
    assert prep.coverage(_records(), multi_pod) == \
        jrep.coverage(_records(), multi_pod)


def test_merge_equals_jax(tmp_path):
    from repro.launch import report as jrep
    from repro_torch.launch import report as prep
    recs = _records()
    paths = [tmp_path / "a.json", tmp_path / "b.json",
             tmp_path / "missing.json"]
    paths[0].write_text(json.dumps(recs[:6]))
    later = [dict(r, status="skipped", reason="again") for r in recs[4:]]
    paths[1].write_text(json.dumps(later))
    assert prep.merge([str(p) for p in paths]) == \
        jrep.merge([str(p) for p in paths])


def test_memory_table_names_the_card(tmp_path, runs):
    from repro_torch.launch import report as prep
    path = tmp_path / "memmodel.json"
    path.write_text(json.dumps(runs[("memreport", "repro_torch", False)]))
    text = prep.memory_table(str(path))
    assert text.splitlines()[0].endswith("fits 80 GB |")
    assert len(text.splitlines()) == 34


def test_parse_override_equals_jax(runs):
    from repro_torch.launch.hillclimb import parse_override
    assert [list(parse_override(s)) for s in OVERRIDES] == runs["parse"]


# ---------------------------------------------------------------------------
# the dry run
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", DRY_ARCHS)
@pytest.mark.parametrize("shape", [s[0] for s in DRY_SHAPES])
def test_dryrun_cell_on_a_fake_2x2_world(arch, shape, runs):
    rec = next(r for r in runs["dryrun"]["records"]
               if r["arch"] == arch and r["shape"] == shape)
    assert rec["status"] == "ok", rec.get("error")
    assert rec["chips"] == 4 and rec["multi_pod"] is False
    assert rec["hlo_flops_per_chip"] > 0 and rec["hlo_bytes_per_chip"] > 0
    colls = rec["collective_bytes_per_chip"]
    assert colls["total"] > 0
    assert colls["total"] == sum(v for k, v in colls.items()
                                 if k != "total")
    assert set(colls) <= {"all-reduce", "all-gather", "reduce-scatter",
                          "all-to-all", "total"}
    mem = rec["memory"]
    assert mem["peak_bytes"] >= mem["argument_bytes"] > 0
    assert mem["temp_bytes"] == mem["peak_bytes"] - mem["argument_bytes"]
    assert rec["dominant"] in ("compute_s", "memory_s", "collective_s")
    assert rec["compute_s"] == rec["hlo_flops_per_chip"] / \
        HW["peak_bf16_flops"]
    if shape == "train_s":
        # the step updates the params and AdamW state in place
        assert mem["alias_bytes"] > 0


def test_dryrun_flops_per_device_sum_to_the_mesh_free_count(runs):
    f = runs["dryrun"]["olmo_flops"]
    print(f"olmo-1b (reduced) train step: per-device flops × 4 / "
          f"mesh-free = {f['ratio']:.4f} ({f['per_device']:.4g} × 4 vs "
          f"{f['mesh_free']:.4g})")
    assert abs(f["ratio"] - 1) <= 0.10


def test_fake_world_meshes_hold_meta_tensors_only(runs):
    for msg in runs["dryrun"]["refused"]:
        assert "fake" in msg and "meta" in msg


def test_device_trace_counts_one_product():
    from repro_torch.launch.dryrun import DeviceTrace, collective_kind
    a = torch.empty((64, 32), device="meta")
    b = torch.empty((32, 16), device="meta")
    trace = DeviceTrace([a, b])
    assert trace.live == trace.peak == (64 * 32 + 32 * 16) * 4
    with trace:
        c = (a @ b).t()
        d = c * 2.0
    assert trace.flops == 2 * 64 * 32 * 16
    # the product reads a and b and writes c; t() is a view; d reads c
    # and writes d
    assert trace.bytes == 4 * (64 * 32 + 32 * 16 + 64 * 16 + 2 * 64 * 16)
    assert trace.peak == 4 * (64 * 32 + 32 * 16 + 2 * 64 * 16)
    del c, d
    assert trace.live == (64 * 32 + 32 * 16) * 4
    assert collective_kind("_c10d_functional::all_gather_into_tensor") == \
        "all-gather"
    assert collective_kind("c10d::allgather_") == "all-gather"
    assert collective_kind("_c10d_functional::reduce_scatter_tensor") == \
        "reduce-scatter"
    assert collective_kind("_c10d_functional::all_to_all_single") == \
        "all-to-all"
    assert collective_kind("aten::mm") is None
    assert np.isfinite(trace.flops)
