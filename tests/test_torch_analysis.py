"""The port's static analysis (``repro_torch.analysis``) on the CPU.

Each rule flags a planted fault with its id: kernel sites over a block's
227 KB, off their route's alignment, with a grid that misses the last
row or writes past the output, a resident operand that does not cover
its array, two blocks writing one tile (K001–K005); a numpy key, a
python scalar, an unhashable knob and a plan memo that grows (R001–R004);
an unmasked ``amax`` over K (M001); a global-generator ``torch.randperm``,
a fast-path dist import, a clock read in compute code, a swallowed
``except`` and a dropped future in a fixture ``serve`` (A001–A005), and
suppressions with and without a justification (S001).  A004/A005 and the
suppression scanner agree with ``repro.analysis`` on the same source
texts; ``RULES``' ids and the report's keys are JAX's (plus A005, which
JAX reports but leaves out of its catalog).  The port's own source and
matrix are clean (``--quick`` and the full matrix), and the autotuner
refuses to promote a plan whose launch fails a K rule.  On a CUDA host
the ``cuda`` test holds K001 against the built libraries at every site.
"""
import dataclasses
import json
import os
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.analysis import (RULES, OperandInfo, active,
                                  apply_suppressions, cache_growth_findings,
                                  check_kernel_site, kernel_sites,
                                  leaf_findings, masked_reduction_findings,
                                  repo_findings, scan_suppressions,
                                  site_from_capture, static_findings,
                                  trace_graph)
from repro_torch.analysis import cli
from repro_torch.analysis import kernels as K
from repro_torch.analysis import targets as T
from repro_torch.kernels import plans, tiling

torch.set_num_threads(1)
SMS = 132                # an H100 SXM's, for planning off the card
BIG = 3.4e38
# cells: narrow (pointnet2's reduced first block), wide (H split 8 ways),
# linear (one layer: dgcnn_c's block-4 widths, K = 20 packed, three F
# tiles), hub_reuse resident (two chunks when forced to 64 rows), the
# entry kernels at the targets' widths
NARROW = dict(b=3, s=48, k=8, d=6, dc=3, h=16, f=32)
WIDE = dict(b=2, s=8, k=20, d=256, dc=256, h=512, f=256)
LINEAR = dict(b=3, s=48, k=20, d=256, dc=256, h=0, f=300)
HUB = dict(b=2, hn=4, c=128, m=4, k=4, d=6, h=8, f=16)
KNN = dict(s=64, n=1024, k=300)
FLASH = dict(b=2, hq=4, hkv=2, sq=64, skv=64, d=64)
FLASH_SPLIT = dict(b=1, hq=4, hkv=2, sq=96, skv=96, d=512)
SSD = dict(bn=4, h=4, q=64, p=16, s=16)


@pytest.fixture(autouse=True)
def _fresh_store():
    plans.configure(None)
    yield
    plans.configure(None)


def _site(kernel, dims, **plan):
    plan.setdefault("provenance", "heuristic")
    return site_from_capture({"kernel": kernel, "dims": dims, "plan": plan},
                             f"planted:{kernel}", sms=SMS)


def _rules(findings):
    return {f.rule for f in findings}


# ---- K001–K005 -------------------------------------------------------------

CLEAN = [("gather_mlp", NARROW, {}),
         ("gather_mlp", NARROW, dict(provenance="override", rows=64)),
         ("gather_mlp", NARROW, dict(provenance="override",
                                     variant="per_cloud")),
         ("gather_mlp", dict(NARROW, k=200), {}),
         ("gather_mlp", WIDE, {}),
         ("gather_mlp", WIDE, dict(provenance="override", nsplit=3)),
         ("gather_mlp", dict(WIDE, k=100, f=700), {}),
         ("hub_reuse", HUB, dict(chunk=128)),
         ("hub_reuse", HUB, dict(chunk=64, variant="per_cloud")),
         ("knn", KNN, {}), ("knn", dict(s=48, n=96, k=8), {}),
         ("knn", dict(s=4096, n=8192, k=2000), {}),
         ("flash_attention", FLASH, dict(dtype="float32")),
         ("flash_attention", FLASH, dict(dtype="bfloat16", aligned=True)),
         ("flash_attention", dict(FLASH, d=256), dict(dtype="bfloat16")),
         ("ssd_chunk", SSD, {}), ("ssd_chunk", dict(SSD, q=128, p=64,
                                                    s=128), {}),
         ("gather_mlp", LINEAR, {}),
         ("gather_mlp", LINEAR, dict(provenance="override", rows=128)),
         ("gather_mlp", LINEAR, dict(provenance="override",
                                     variant="per_cloud")),
         ("gather_mlp", dict(LINEAR, k=200, d=700), {})]


@pytest.mark.parametrize("kernel,dims,plan", CLEAN,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CLEAN)])
def test_derived_sites_are_clean(kernel, dims, plan):
    site = _site(kernel, dims, **plan)
    assert check_kernel_site(site) == []
    assert site.smem > 0 and site.grid


def test_wide_site_merges_its_h_splits():
    site = _site("gather_mlp", WIDE)
    assert site.launch["nsplit"] == 8 and site.semantics[-1] == K.MERGE
    # the same launch with the split pass read as parallel: 8 blocks
    # write each tile and nothing merges them
    race = dataclasses.replace(site, semantics=(K.PARALLEL,) * 4)
    assert "K005" in _rules(check_kernel_site(race))


def test_k001_site_over_227_kb():
    # every resident plan fits (a call one resident launch does not
    # cover takes the layered route, in fixed shared memory): a layered
    # site planted past 227 KB
    hub = _site("hub_reuse", dict(HUB, d=387))
    assert hub.launch["route"] == "layered"
    assert check_kernel_site(hub) == []
    over = dataclasses.replace(hub, smem=tiling.MAX_SMEM + 1)
    assert _rules(check_kernel_site(over)) == {"K001"}
    dims = dict(b=2, s=64, k=32, d=192, dc=3, h=192, f=256)
    forced = _site("gather_mlp", dims, provenance="override", rows=128)
    assert "K001" in _rules(check_kernel_site(forced))
    assert check_kernel_site(_site("gather_mlp", dims)) == []  # drops to 64
    lib = dataclasses.replace(_site("gather_mlp", NARROW),
                              smem_library=1 + _site("gather_mlp",
                                                     NARROW).smem)
    assert _rules(check_kernel_site(lib)) == {"K001"}


def test_k002_route_preconditions():
    rows = _site("gather_mlp", NARROW, provenance="override", rows=96)
    assert "K002" in _rules(check_kernel_site(rows))
    chunk = _site("hub_reuse", HUB, chunk=96)
    assert "K002" in _rules(check_kernel_site(chunk))
    assert _site("flash_attention", FLASH,
                 dtype="bfloat16").launch["route"] == "wgmma"
    ssd = _site("ssd_chunk", dict(SSD, q=0))
    assert "K002" in _rules(check_kernel_site(ssd))
    assert check_kernel_site(_site("ssd_chunk", dict(SSD, q=160))) == []


def test_k003_grid_misses_the_last_row():
    site = _site("gather_mlp", NARROW)
    nb, groups = site.grid
    short = dataclasses.replace(site, grid=(nb, groups - 1))
    fs = check_kernel_site(short)
    assert _rules(fs) == {"K003"} and "unwritten" in fs[0].message
    over = dataclasses.replace(site, grid=(nb, groups + 1))
    assert "outside" in check_kernel_site(over)[0].message
    hub = _site("hub_reuse", HUB, chunk=64)
    gap = dataclasses.replace(hub, coverage=[(
        "launches [64] cover the 128 cache rows", False)])
    assert _rules(check_kernel_site(gap)) == {"K003"}
    # the plan that launched (rows 64) is not the one derived (128)
    launched = _site("gather_mlp", dict(NARROW, b=64, s=512), rows=64)
    assert launched.launch["rows"] == 128
    assert _rules(check_kernel_site(launched)) == {"K003"}


def test_linear_site_from_tiling():
    """The linear route's launch from tiling.py: a row-tile group by F
    tile grid (F tiles of up to 256 columns), its two kernels and W's
    scratch, the rows knob the plan launched held to the
    derived one (K003), a row tile off 64 / 128 refused (K002), the row
    tiles of a subset past the tile covering it (K003)."""
    site = _site("gather_mlp", LINEAR)
    lp = tiling.linear_plan(3, 48, 20, 300, SMS)
    assert site.launch == dict(route="linear", **lp, kernels=2,
                               scratch=tiling.linear_scratch(256, 300))
    assert lp["nft"] == 2 and lp["n"] == 192     # F = 300: 2 x 192
    assert site.grid == (1, lp["groups"], 2) and site.smem == lp["smem"]
    assert check_kernel_site(site) == []
    launched = _site("gather_mlp", LINEAR, rows=128)
    assert launched.launch["rows"] == 64
    assert _rules(check_kernel_site(launched)) == {"K003"}
    odd = _site("gather_mlp", LINEAR, provenance="override", rows=96)
    assert "K002" in _rules(check_kernel_site(odd))
    long = _site("gather_mlp", dict(LINEAR, k=200))
    assert long.launch["rows"] == 128 and long.launch["n_tiles"] == 2
    assert check_kernel_site(long) == []
    gap = dataclasses.replace(long, coverage=[("1 row tile of 128 covers "
                                               "a subset's 200 rows",
                                               False)])
    assert _rules(check_kernel_site(gap)) == {"K003"}


def test_k004_resident_operand_must_cover():
    site = _site("gather_mlp", WIDE)
    (x,) = site.operands
    assert x.resident and check_kernel_site(site) == []
    short = dataclasses.replace(site, operands=[OperandInfo(
        "x", x.array_shape, (64, 128), True)])
    assert _rules(check_kernel_site(short)) == {"K004"}


def test_k005_two_blocks_write_one_tile():
    site = _site("gather_mlp", NARROW)
    twice = dataclasses.replace(site, grid=(1, 2 * site.grid[1]),
                                out_map=lambda p: [(p[0], p[1] // 2, 0)])
    assert _rules(check_kernel_site(twice)) == {"K005"}
    hub = _site("hub_reuse", HUB, chunk=64)
    assert hub.grid[1] == 2 and check_kernel_site(hub) == []
    race = dataclasses.replace(hub, semantics=(K.PARALLEL,) * 4)
    assert _rules(check_kernel_site(race)) == {"K005"}


def test_entry_kernel_launches_follow_their_sources():
    kp = K.knn_plan(64, 1024, 300, SMS)
    assert (kp["w"], kp["r"], kp["kcap"], kp["scratch"]) == (8, 4, 128, 0)
    assert K.knn_plan(4096, 8192, 2000, SMS)["scratch"] > 0
    assert K.flash_route("bfloat16", 64, True) == "wgmma"
    assert K.flash_route("bfloat16", 64, False) == "mma"
    assert K.flash_route("float32", 64, True) == "mma"
    assert K.flash_layout("wgmma", "bfloat16", 128)["smem"] == \
        2 * 16384 * 5 + 72 + 1024
    sp = K.ssd_plan(4, 80, 64, 64, 128, SMS)
    assert 1 <= sp["hg"] <= 16 and sp["grid"][1] * sp["hg"] >= 80


def _library_answers(monkeypatch, shift=0):
    """Stand-ins for the entry kernels' library queries on a host with no
    card: the analysis's own formulas, each count ``shift`` off."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.knn import ops as knn_ops
    from repro_torch.kernels.ssd_chunk import ops as ssd_ops

    def layout(route, dtype, d):
        lay = K.flash_layout(route, dtype, d)
        return dict(lay, bq=lay["bq"] + shift, smem=lay["smem"] + shift,
                    threads=0, cluster=lay.get("cluster", 1) + shift)

    def plan(bn, h, q, p, s):
        sp = K.ssd_plan(bn, h, q, p, s, SMS)
        return dict(qp=sp["qp"], hg=sp["hg"], grid_x=sp["grid"][0],
                    grid_y=sp["grid"][1] + shift, smem=sp["smem"] + shift)
    monkeypatch.setattr(flash_ops, "library_layout", layout)
    monkeypatch.setattr(ssd_ops, "library_plan", plan)
    monkeypatch.setattr(knn_ops, "library_smem",
                        lambda s, n, k: K.knn_plan(s, n, k, SMS)["smem"]
                        + shift)


@pytest.mark.parametrize("kernel,dims,plan", [
    ("knn", KNN, {}),
    ("flash_attention", FLASH, {"dtype": "bfloat16", "aligned": True}),
    ("flash_attention", FLASH, {"dtype": "float32"}),
    ("flash_attention", FLASH_SPLIT, {"dtype": "bfloat16"}),
    ("ssd_chunk", SSD, {})])
def test_entry_sites_are_held_to_their_libraries(monkeypatch, kernel, dims,
                                                 plan):
    """On the card the entry kernels' libraries answer for their own
    launch (``knn_smem_bytes``, ``flash_attention_layout``,
    ``ssd_chunk_plan``): a library that agrees with the formulas gives a
    clean site; one planted to differ fails K001 (shared memory) and,
    where it also reports tiles or a grid, K003."""
    entry = {"kernel": kernel, "dims": dims, "plan": plan}
    _library_answers(monkeypatch)
    site = site_from_capture(entry, "t", sms=SMS, card=True)
    assert site.smem_library == site.smem
    assert check_kernel_site(site) == []
    _library_answers(monkeypatch, shift=16)
    site = site_from_capture(entry, "t", sms=SMS, card=True)
    want = {"K001"} if kernel == "knn" else {"K001", "K003"}
    assert _rules(check_kernel_site(site)) == want


# ---- R001–R004 -------------------------------------------------------------

def test_r001_numpy_or_other_device_operands():
    from repro_torch.engine.params import Batch
    b = Batch.make(np.zeros((2, 8, 3), np.float32), device="cpu")
    assert leaf_findings({"batch": b}, device="cpu") == []
    fs = leaf_findings({"batch": b}, device="cuda")
    assert _rules(fs) == {"R001"} and len(fs) == 4
    keys = np.zeros((2, 2), np.uint32)
    fs = leaf_findings({"keys": keys, "xyz": b.xyz}, where="ops",
                       device="cpu")
    assert [(f.rule, f.where) for f in fs] == [("R001", "ops['keys']")]


def test_r002_python_scalar_operand():
    fs = leaf_findings({"scale": 0.125, "x": torch.ones(2)}, device="cpu")
    assert [(f.rule, f.severity) for f in fs] == [("R002", "warning")]


def test_r003_unhashable_knob():
    assert static_findings({"rows": 64, "spec": T.reduced_specs()[
        "pointnet2"]}) == []
    fs = static_findings({"kernel_kw.rows": [64]})
    assert _rules(fs) == {"R003"}
    # the wrappers memoise on the knob: the call cannot resolve
    from repro_torch.kernels.gather_mlp import gather_mlp
    z = torch.zeros
    with pytest.raises(TypeError):
        gather_mlp(z(1, 2, 4, 3), z(1, 2, 3), z(3, 8), z(8), z(8, 4), z(4),
                   rows=[64])


def test_r004_plan_memo_growth():
    from repro_torch.kernels.gather_mlp import gather_mlp
    z = torch.zeros

    def call(k):
        gather_mlp(z(1, 2, k, 3), z(1, 2, 3), z(3, 8), z(8), z(8, 4), z(4))
    fs = cache_growth_findings(call, [(4,), (5,), (6,)], where="planted")
    assert _rules(fs) == {"R004"} and "gather_mlp_plans" in fs[0].message
    assert cache_growth_findings(call, [(4,), (4,), (4,)]) == []


def test_r004_engine_input_mixes_resolve_once():
    assert cli.retrace_exec_findings("cpu") == []


# ---- M001 ------------------------------------------------------------------

def _graph(fn, *shapes):
    gen = torch.Generator().manual_seed(0)
    args = [torch.randn(s, generator=gen) if len(s) > 1 or s[0] > 1
            else torch.ones(s) for s in shapes]
    if fn.__code__.co_argcount > len(args):
        args.append(torch.rand(shapes[0][:3], generator=gen) > 0.3)
    return trace_graph(fn, *args)


def test_m001_unmasked_amax_over_k():
    fs = masked_reduction_findings(_graph(lambda y: y.amax(2),
                                          (3, 16, 8, 32)),
                                   point_sizes={96, 8}, where="planted")
    assert _rules(fs) == {"M001"}
    assert fs[0].where == "planted/amax(3x16x8x32)@dims(2)"


@pytest.mark.parametrize("name,fn,flagged", [
    ("where", lambda y, m: torch.where(m[..., None], y, -BIG).amax(2),
     False),
    ("masked_fill", lambda y, m: y.masked_fill(~m[..., None], -BIG).amax(2),
     False),
    ("zero_fill_sum", lambda y, m: torch.where(m[..., None], y, 0.).sum(2),
     False),
    ("guard_consumed_by_matmul",
     lambda y, m: (torch.where(m[..., None], y, -BIG) @ torch.ones(
         32, 32)).amax(2), True),
    ("max_dim", lambda y, m: y.max(dim=2)[0], True),
    ("non_point_axis", lambda y, m: y.amax(3), False),
])
def test_m001_guards(name, fn, flagged):
    fs = masked_reduction_findings(_graph(fn, (3, 16, 8, 32)),
                                   point_sizes={96, 8})
    assert (_rules(fs) == {"M001"}) is flagged, fs


# ---- A001–A005, S001 -------------------------------------------------------

SERVE_BAD = """\
    def fire_swallowing(fn, batch):          # A004: silently eaten
        try:
            return fn(batch)
        except Exception:
            pass


    def fire_bare(fn, batch):                # A004: bare except
        try:
            return fn(batch)
        except:
            return None


    def fire_converting(fn, batch, outcomes):  # ok: uses the error
        try:
            return fn(batch)
        except Exception as e:
            outcomes.append(repr(e))


    def fire_reraising(fn, batch):           # ok: re-raises
        try:
            return fn(batch)
        except Exception:
            raise RuntimeError("dispatch failed")


    def fire_narrow(fn, batch):              # ok: not a blanket catch
        try:
            return fn(batch)
        except KeyError:
            return None


    def fire_and_forget(pool, fn, batch):    # A005: result discarded
        pool.submit(fn, batch)
        return True


    def fire_state_check_only(pool, fn, batch):  # A005: .done() never
        fut = pool.submit(fn, batch)             # surfaces the error
        return fut.done()


    def fire_joined(pool, fn, batch):        # ok: joined inline
        return pool.submit(fn, batch).result()


    def fire_callback(rec, pool, fn, batch):  # ok: completion path
        rec.future = pool.submit(fn, batch)
        rec.future.add_done_callback(print)


    def fire_handed_off(pool, fn, batch, futs):  # ok: escapes
        f = pool.submit(fn, batch)
        futs.append(f)


    def admit(queue, xyz):                   # ok: not a future at all
        req = queue.submit(xyz)
        return req.rid
    """


def _write(root, rel, text):
    path = os.path.join(root, rel)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w", encoding="utf-8") as fh:
        fh.write(textwrap.dedent(text))


@pytest.fixture
def bad_repo(tmp_path):
    src = str(tmp_path / "src")
    _write(src, "repro_torch/__init__.py", "")
    _write(src, "repro_torch/dist/__init__.py", "")
    _write(src, "repro_torch/engine/__init__.py", """\
        import repro_torch.dist


        def apply(mesh=None):
            if mesh is not None:
                from torch import distributed   # ok: deferred
                return distributed
        """)
    _write(src, "repro_torch/serve/__init__.py", """\
        from torch import distributed as dist
        """)
    _write(src, "repro_torch/core/bad.py", """\
        import time

        import torch


        def sample(n):
            t0 = time.time()
            idx = torch.randperm(n)
            return idx, t0


        def sample_seeded(n, gen):
            x = torch.empty(n).uniform_(generator=gen)   # ok
            return torch.randperm(n, generator=gen), x  # ok


        def sample_inplace(n):
            return torch.empty(n).normal_()


        def sample_ok(n):
            # analysis: allow A001 -- golden-fixture suppression test
            return torch.randperm(n)


        def sample_unjustified(n):
            return torch.randperm(n)  # analysis: allow A001
        """)
    _write(src, "repro_torch/serve/bad.py", SERVE_BAD)
    # outside repro_torch.serve neither A004 nor A005 applies, and a
    # clock outside the compute packages is fine
    _write(src, "repro_torch/launch/swallow.py", """\
        import time


        def best_effort(fn):
            t0 = time.perf_counter()
            try:
                return fn(), t0
            except Exception:
                return None


        def best_effort_submit(pool, fn):
            pool.submit(fn)
        """)
    return src


def test_forbidden_ast_patterns_flagged(bad_repo):
    fs = repo_findings(bad_repo)
    act = active(fs)
    by = {r: [f for f in act if f.rule == r] for r in RULES}
    # A001: the global-generator randperm, the in-place normal_ and the
    # unjustified suppression's; the seeded calls stay clean
    assert len(by["A001"]) == 3, by["A001"]
    assert all("core/bad.py" in f.where for f in by["A001"])
    # A002: the engine's module-level dist import and serve's torch one
    assert len(by["A002"]) == 2, by["A002"]
    assert {f.where.split("src/")[1].split(":")[0] for f in by["A002"]} == {
        "repro_torch/engine/__init__.py", "repro_torch/serve/__init__.py"}
    assert len(by["A003"]) == 1 and "core/bad.py" in by["A003"][0].where
    assert len(by["A004"]) == 2 and len(by["A005"]) == 2
    assert all("serve/bad.py" in f.where for f in by["A004"] + by["A005"])
    suppressed = [f for f in fs if f.suppressed]
    assert [f.rule for f in suppressed] == ["A001"]
    assert "golden-fixture" in suppressed[0].justification
    assert len(by["S001"]) == 1


def test_a004_a005_agree_with_jax(tmp_path):
    from repro.analysis.repolint import repo_findings as jax_repo_findings
    out = {}
    for pkg, fn in (("repro", jax_repo_findings),
                    ("repro_torch", repo_findings)):
        src = str(tmp_path / pkg)
        _write(src, f"{pkg}/__init__.py", "")
        _write(src, f"{pkg}/serve/__init__.py", "")
        _write(src, f"{pkg}/serve/bad.py", SERVE_BAD)
        out[pkg] = sorted((f.rule, f.line, f.message.split(" in ")[0])
                          for f in fn(src) if f.rule in ("A004", "A005"))
    assert out["repro"] == out["repro_torch"] and len(out["repro"]) == 4


def test_suppressions_behave_as_jax(tmp_path):
    from repro.analysis.findings import scan_suppressions as jax_scan
    p = str(tmp_path / "x.py")
    with open(p, "w") as fh:
        fh.write("# analysis: allow K002 */gather_mlp* -- planted\n"
                 "# analysis: allow M001\n"
                 "x = 1  # analysis: allow R003 -- inline\n")
    sups, meta = scan_suppressions(p)
    jsups, jmeta = jax_scan(p)
    assert [(s.rule, s.pattern, s.justification, s.line) for s in sups] \
        == [(s.rule, s.pattern, s.justification, s.line) for s in jsups]
    assert [(m.rule, m.line) for m in meta] == [(m.rule, m.line)
                                               for m in jmeta] == [
        ("S001", 2)]
    site = dataclasses.replace(_site("hub_reuse", HUB, chunk=96),
                               where="engine:x/gather_mlp#0")
    fs = apply_suppressions(check_kernel_site(site), sups)
    assert fs and all(f.suppressed for f in fs)
    assert fs[0].justification == "planted"


def test_rules_and_report_keys_are_jax():
    from repro.analysis import RULES as JAX_RULES
    from repro.analysis.cli import build_report as jax_report
    assert "A005" not in JAX_RULES
    assert set(RULES) == set(JAX_RULES) | {"A005"}
    assert {r: s for r, (s, _) in RULES.items() if r in JAX_RULES} == {
        r: s for r, (s, _) in JAX_RULES.items()}
    ours, theirs = cli.build_report([], [], "quick"), jax_report([], [],
                                                                 "quick")
    assert ours.keys() == theirs.keys()
    assert ours["summary"].keys() == theirs["summary"].keys()


def test_repo_source_is_clean():
    fs = repo_findings()
    assert active(fs) == [], [str(f) for f in active(fs)]
    assert all(f.justification for f in fs if f.suppressed)


# ---- the matrix ------------------------------------------------------------

JAX_ROW = {"target", "site", "grid", "dimension_semantics",
           "footprint_bytes", "vmem_budget_mb"}


def test_cli_quick_strict_and_report(tmp_path):
    out = str(tmp_path / "report.json")
    assert cli.main(["--quick", "--strict", "--json", out,
                     "--device", "cpu"]) == 0
    rep = json.load(open(out))
    assert rep["level"] == "quick" and rep["summary"]["strict_ok"]
    assert rep["summary"]["errors"] == 0
    assert set(rep["rules"]) == set(RULES)
    rows = rep["kernel_sites"]
    assert rows and all(JAX_ROW <= set(r) for r in rows)
    for mode in ("traditional", "lpcn"):
        kinds = {r["kernel"] for r in rows
                 if r["target"] == f"engine:pointnet2/{mode}/cuda"}
        assert kinds == ({"gather_mlp", "hub_reuse"} if mode == "lpcn"
                         else {"gather_mlp"})
    assert not any(r["target"].endswith("/reference") for r in rows)


def test_cli_and_matrix_default_to_the_card(monkeypatch, capsys):
    """As every entry point of the port: no ``--device`` means the card,
    and a host without one is refused (exit 2), not run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(["--quick", "--no-repo"]) == 2
    assert "--device cpu" in capsys.readouterr().err
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.default_targets(models=("pointnet2",), include_serve=False,
                          include_dist=False, include_entries=False)


def test_full_matrix_is_clean():
    """Every target of the full matrix (4 families x 2 modes x 2 backends,
    the serving partial batch, the one-rank sharded engine, the entry
    kernels and hub_reuse's routes past the reduced specs) runs, traces
    and lints with no unsuppressed finding; every family has sites, every
    lpcn ``cuda`` target both FC kernels', every entry target its
    kernel's, and the routes past the old limits (hub_reuse ``stream``,
    ssd_chunk ``tiled``, flash ``split``) theirs."""
    sups, meta = cli._src_suppressions(None)
    tl = T.default_targets(device="cpu")
    assert len(tl) == 4 * 2 * 2 + 2 + len(T.ENTRIES)
    findings, rows = cli.analyze_targets(tl, suppressions=sups)
    assert meta == []
    assert active(findings) == [], [str(f) for f in active(findings)]
    assert all(f.justification for f in findings if f.suppressed)
    for fam in T.MODELS:
        assert any(r["family"] == fam for r in rows), fam
    for t in tl:
        kinds = {r["kernel"] for r in rows if r["target"] == t.name}
        if t.name.endswith("lpcn/cuda"):
            assert kinds == {"gather_mlp", "hub_reuse"}, t.name
        elif t.name.startswith("entry:"):
            assert kinds == {t.name.split(":")[1]}, t.name
    routes = {(r["kernel"], r["launch"].get("route")) for r in rows}
    assert {("hub_reuse", "layered"), ("ssd_chunk", "tiled"),
            ("flash_attention", "split")} <= routes, routes


def test_autotune_refuses_a_plan_that_fails_a_k_rule(monkeypatch):
    """The cost model makes rows=64 the fastest; its launch planted to
    miss the last row, the tuner promotes the next clean plan."""
    from repro_torch.launch import autotune
    derive = K._DERIVE["gather_mlp"]

    def planted(dims, plan, where, sms, card):
        site = derive(dims, plan, where, sms, card)
        if site.launch.get("rows") == 64:
            nb, groups = site.grid
            site = dataclasses.replace(site, grid=(nb, groups - 1))
        return site
    monkeypatch.setitem(K._DERIVE, "gather_mlp", planted)
    dims = dict(b=2, s=16, k=4, d=6, dc=3, h=8, f=16)

    def cost(call, knobs):
        return 1000.0 if "variant" in knobs else float(sum(knobs.values()))
    store = plans.PlanStore()
    entry = autotune.autotune_cell("gather_mlp", dims, store=store,
                                   timer=cost, device="cpu", sms=SMS)
    assert entry["rows"] == 128
    rejected = {r["knobs"].get("rows"): r["rejected"]
                for r in entry["candidates"]}
    assert rejected[64].startswith("K003") and rejected[128] is None


def test_autotune_raises_when_no_plan_passes_the_k_rules(monkeypatch):
    """Every batched candidate's launch planted to miss the last row: the
    tuner promotes nothing and says why, rather than take a plan that
    failed the gate."""
    from repro_torch.launch import autotune
    derive = K._DERIVE["gather_mlp"]

    def planted(dims, plan, where, sms, card):
        site = derive(dims, plan, where, sms, card)
        if plan.get("variant") != "per_cloud":
            nb, groups = site.grid
            site = dataclasses.replace(site, grid=(nb, groups - 1))
        return site
    monkeypatch.setitem(K._DERIVE, "gather_mlp", planted)
    dims = dict(b=2, s=16, k=4, d=6, dc=3, h=8, f=16)
    store = plans.PlanStore()
    with pytest.raises(RuntimeError, match="no batched plan .* passes the "
                                           "gate.*K003"):
        autotune.autotune_cell("gather_mlp", dims, store=store,
                               timer=lambda call, knobs: 1.0,
                               device="cpu", sms=SMS)
    assert not store.entries


@pytest.mark.cuda
def test_k001_matches_the_library_at_every_site():
    """On the card: the quick matrix's and the entry kernels' sites, each
    site's shared memory by tiling.py or the analysis's formulas equal to
    the library's (``*_smem_bytes``, ``flash_attention_layout``,
    ``ssd_chunk_plan``), each wide plan to ``gather_mlp_wide_plan``, each
    knn plan to ``knn_plan``, flash's tiles and ssd_chunk's heads a block
    and grid to their libraries', and every card site to its CPU twin."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    kw = dict(models=("pointnet2", "dgcnn"), modes=T.MODES,
              backends=("cuda",), include_serve=False, include_dist=False)
    cpu = T.default_targets(device="cpu", **kw)
    card = T.default_targets(device="cuda", **kw)
    sups, _ = cli._src_suppressions(None)
    findings, rows = cli.analyze_targets(cpu, suppressions=sups,
                                         card_targets=card)
    assert active(findings) == [], [str(f) for f in active(findings)]
    assert {r["kernel"] for r in rows} == set(K._DERIVE)
    assert all(r["smem_library"] == r["footprint_bytes"] for r in rows)
    assert all(r["matches_cpu"] for r in rows)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    sites = kernel_sites([{"kernel": "gather_mlp", "dims": WIDE,
                           "plan": {"provenance": "heuristic"}}],
                         sms=sms, card=True)
    assert check_kernel_site(sites[0]) == []
