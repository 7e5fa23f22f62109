"""The port's tile plans, autotuner and per-cloud FC dispatch
(``repro_torch.kernels.{plans,tiling}``, ``repro_torch.launch.autotune``,
the ``kernel_kw`` of the engine and the ``"cuda_per_cloud"`` backend),
after ``tests/test_autotune.py``'s contracts: the store round-trips, a
corrupt or mis-versioned store or an invalid entry warns and degrades to
the heuristic, an entry of another card is a miss, the same seed and
timer pick the same winner, and a stored plan replaces the heuristic on
the default engine path with the logits unchanged; plus ``plan_key``
against the JAX package's, and the per-cloud backend's logits against
JAX's ``"pallas_vmap"``.

On a CUDA host the ``cuda``-marked tests hold each forced knob against
the heuristic's launch (``rows`` and ``chunk`` bit-equal, ``nsplit``
within 1e-4), tiling.py's shared memory against the library's, and
``autotune_cell`` on a real cell; the JAX package is imported only
inside the tests that compare with it."""
import json
from dataclasses import replace

import numpy as np
import pytest
import torch

from repro_torch import engine
from repro_torch.data.synthetic import make_cloud
from repro_torch.engine import archs
from repro_torch.kernels import plans, tiling
from repro_torch.launch import autotune
from repro_torch.models import pointnet2

torch.set_num_threads(1)

# small cells; the injected timer never runs a kernel
GDIMS = {"b": 2, "s": 16, "k": 4, "d": 6, "dc": 3, "h": 8, "f": 16}
HDIMS = {"b": 2, "hn": 4, "c": 8, "m": 4, "k": 4, "d": 6, "h": 8, "f": 16}
WDIMS = {"b": 2, "s": 8, "k": 20, "d": 256, "dc": 256, "h": 512, "f": 256}
SMS = 132                       # an H100 SXM's, for planning off the card
BLOCKS = ((48, 8, (16, 16, 32)), (16, 8, (32, 32, 48)))
SPEC = replace(pointnet2.POINTNET2_C,
               blocks=tuple(engine.BlockSpec(*b) for b in BLOCKS),
               global_mlp=(32, 64), head_dims=(32,), n_classes=10)
SIZES = (160, 120, 75, 0)       # full, padded, padded, an empty fill


@pytest.fixture(autouse=True)
def _fresh_store():
    """Every test on an empty in-memory store, whatever
    results/tile_plans_torch.json holds."""
    plans.configure(None)
    yield
    plans.configure(None)


def cost_model(call, knobs):
    """Injected timer: ranks plans by their knob, so the winner is
    knowable; the per-cloud launch costs 1000."""
    if "variant" in knobs:
        return 1000.0
    return float(sum(knobs.values()))


def per_cloud_wins(call, knobs):
    return 1.0 if "variant" in knobs else cost_model(call, knobs)


def _entry(**knobs):
    return {**knobs, "provenance": "autotuned", "measured_ms": 0.125}


def _operands(kernel, dims, seed=0):
    return autotune.synth_cell_args(kernel, dims, seed=seed, device="cpu")


def _run(kernel, args, **kw):
    return autotune.cell_call(kernel, args, kw)()


def _batch(sizes=SIZES, seed=0):
    rng = np.random.default_rng(seed)
    clouds = [np.asarray(make_cloud(rng, n), np.float32) if n
              else np.zeros((0, 3), np.float32) for n in sizes]
    return engine.Batch.from_clouds(clouds, device="cpu")


@pytest.fixture(scope="module")
def params():
    p = engine.init(SPEC, seed=0, device="cpu")
    for mlp in (*p.blocks, p.global_mlp, p.head):
        for layer in mlp.layers:
            layer.b.add_(0.05)
    return p


# ---- keys and the store ----------------------------------------------------

@pytest.mark.parametrize("kernel,dims", [("gather_mlp", GDIMS),
                                         ("hub_reuse", HDIMS),
                                         ("gather_mlp", WDIMS)])
def test_plan_key_matches_jax(kernel, dims):
    from repro.kernels import plans as jplans
    assert plans.plan_key(kernel, dims) == jplans.plan_key(kernel, dims)
    assert plans.store_key(kernel, dims, "cpu") == \
        "cpu|" + jplans.plan_key(kernel, dims)


def test_save_load_round_trips_bit_identically(tmp_path):
    store = plans.PlanStore()
    store.record("gather_mlp", GDIMS, _entry(rows=128), device="cpu")
    store.record("gather_mlp", WDIMS, _entry(nsplit=3), device="cpu")
    store.record("hub_reuse", HDIMS, _entry(chunk=64, speedup=1.5),
                 device="cpu")
    path = store.save(str(tmp_path / "plans.json"))
    assert json.loads(open(path).read())["version"] == 1
    loaded = plans.PlanStore.load(path)
    assert loaded.entries == store.entries
    path2 = loaded.save(str(tmp_path / "plans2.json"))
    assert open(path).read() == open(path2).read()


@pytest.mark.parametrize("text,match", [
    ("{not json", "unreadable"),
    (json.dumps({"version": 999, "plans": {}}), "version"),
    (json.dumps([1, 2]), "version")])
def test_corrupt_store_warns_and_degrades(tmp_path, text, match):
    p = tmp_path / "plans.json"
    p.write_text(text)
    with pytest.warns(RuntimeWarning, match=match):
        store = plans.PlanStore.load(str(p))
    assert len(store) == 0


def test_invalid_entries_dropped_not_fatal(tmp_path):
    good = plans.store_key("gather_mlp", GDIMS, "cpu")
    raw = {"version": plans.VERSION, "plans": {
        good: _entry(rows=64),
        "cpu|gather_mlp|b=1,s=8": {"rows": 96, "provenance": "autotuned"},
        "cpu|conv2d|b=1": _entry(rows=64),
        "gather_mlp|b=1,s=8": _entry(rows=64),          # no card in the key
        "cpu|hub_reuse|b=2,hn=4": {"chunk": 64, "provenance": "heuristic"},
        "cpu|hub_reuse|b=2,hn=8": _entry(rows=64),      # another kernel's
    }}
    p = tmp_path / "plans.json"
    p.write_text(json.dumps(raw))
    with pytest.warns(RuntimeWarning, match="dropping entry"):
        store = plans.PlanStore.load(str(p))
    assert list(store.entries) == [good]
    assert store.lookup("gather_mlp", device="cpu", **GDIMS) is not None


@pytest.mark.parametrize("kernel,entry,match", [
    ("gather_mlp", {"rows": 0, "provenance": "autotuned"}, "rows"),
    ("gather_mlp", {"rows": 96, "provenance": "autotuned"}, "rows"),
    ("gather_mlp", {"rows": 64, "nsplit": 2, "provenance": "autotuned"},
     "exactly one"),
    ("gather_mlp", {"nsplit": 0, "provenance": "autotuned"}, "nsplit"),
    ("gather_mlp", {"rows": 64.0, "provenance": "autotuned"}, "int"),
    ("gather_mlp", {"rows": 64, "provenance": "guess"}, "provenance"),
    ("gather_mlp", {"chunk": 64, "provenance": "autotuned"}, "not knobs"),
    ("hub_reuse", {"chunk": 32, "provenance": "autotuned"}, "chunk"),
    ("hub_reuse", {"provenance": "autotuned"}, "exactly one"),
    ("hub_reuse", {"variant": "vmap", "provenance": "autotuned"},
     "variant"),
    ("hub_reuse", {"variant": "per_cloud", "chunk": 64,
                   "provenance": "autotuned"}, "sets no knob"),
    ("hub_reuse", {"variant": "per_cloud", "provenance": "heuristic"},
     "provenance")])
def test_record_rejects_invalid_plans(kernel, entry, match):
    store = plans.PlanStore()
    dims = GDIMS if kernel == "gather_mlp" else HDIMS
    with pytest.raises(ValueError, match="refusing to record"):
        store.record(kernel, dims, entry, device="cpu")
    assert match in plans.entry_error(kernel, entry)


def test_unknown_kernel_key_raises():
    with pytest.raises(ValueError, match="unknown kernel"):
        plans.plan_key("conv2d", GDIMS)


def test_another_cards_entry_is_a_miss():
    store = plans.active_store()
    key = store.record("gather_mlp", GDIMS, _entry(rows=128), device="cpu")
    store.entries["NVIDIA H100 80GB HBM3" + key[len("cpu"):]] = \
        store.entries.pop(key)
    plans._clear_kernel_caches()
    args = _operands("gather_mlp", GDIMS)
    with plans.capture() as cap:
        _run("gather_mlp", args)
    assert cap[-1]["plan"]["provenance"] == "heuristic"
    assert plans.active_store().lookup("gather_mlp", device="cpu",
                                       **GDIMS) is None


# ---- resolution: hit, miss, stale, bypass, capture ------------------------

@pytest.mark.parametrize("kernel,dims,knob", [
    ("gather_mlp", GDIMS, {"rows": 128}),
    ("gather_mlp", WDIMS, {"nsplit": 2}),
    ("hub_reuse", HDIMS, {"chunk": 64})])
def test_store_hit_resolves_autotuned_and_miss_falls_back(kernel, dims,
                                                          knob):
    args = _operands(kernel, dims)
    with plans.capture() as cap:
        base = _run(kernel, args)
    assert cap[-1]["plan"]["provenance"] == "heuristic"
    plans.active_store().record(kernel, dims, _entry(**knob), device="cpu")
    with plans.capture() as cap:
        out = _run(kernel, args)
    plan = cap[-1]["plan"]
    assert plan["provenance"] == "autotuned" and plan["variant"] == "batched"
    assert all(plan[k] == v for k, v in knob.items())
    assert torch.equal(out, base)
    # another shape is a miss: the heuristic, silently
    other = dict(dims, b=1)
    with plans.capture() as cap:
        _run(kernel, _operands(kernel, other))
    assert cap[-1]["plan"]["provenance"] == "heuristic"
    # an explicit knob beats the hit
    with plans.capture() as cap:
        _run(kernel, args, **knob)
    assert cap[-1]["plan"]["provenance"] == "override"


def test_heuristic_knob_unknown_off_the_card():
    """The narrow route's heuristic tile depends on the card's SM count:
    a CPU call records the source and the dims and leaves it unset."""
    with plans.capture() as cap:
        _run("gather_mlp", _operands("gather_mlp", GDIMS))
        _run("hub_reuse", _operands("hub_reuse", HDIMS))
    g, h = cap
    assert g["dims"] == GDIMS and g["plan"]["route"] == "narrow"
    assert g["plan"]["rows"] is None and g["plan"]["nsplit"] is None
    assert h["dims"] == HDIMS and h["plan"]["chunk"] == 128


@pytest.mark.parametrize("kernel,dims,knob", [
    ("gather_mlp", GDIMS, {"nsplit": 2}),       # the other route's knob
    ("gather_mlp", WDIMS, {"rows": 64}),
    ("gather_mlp", WDIMS, {"nsplit": 17}),      # past H / 32
    ("hub_reuse", dict(HDIMS, c=128, d=387), {"chunk": 128})])
def test_infeasible_store_entry_warns_and_falls_back(kernel, dims, knob):
    """An entry that no longer fits (here: it never did) is not served:
    the wrapper warns and the heuristic plans the call."""
    plans.active_store().record(kernel, dims, _entry(**knob), device="cpu")
    with pytest.warns(RuntimeWarning, match="no longer fits"), \
            plans.capture() as cap:
        _run(kernel, _operands(kernel, dims))
    assert cap[-1]["plan"]["provenance"] == "heuristic"


@pytest.mark.parametrize("kernel,dims,knob,match", [
    ("gather_mlp", dict(GDIMS, k=32, d=192, h=192, f=256), {"rows": 128},
     "shared memory"),
    ("gather_mlp", GDIMS, {"rows": 96}, "rows"),
    ("gather_mlp", GDIMS, {"nsplit": 1}, "other one"),
    ("gather_mlp", WDIMS, {"rows": 64}, "other one"),
    ("gather_mlp", WDIMS, {"nsplit": 17}, "1..16"),
    ("hub_reuse", HDIMS, {"chunk": 32}, "chunk"),
    ("hub_reuse", dict(HDIMS, c=128, d=387), {"chunk": 128},
     "shared memory"),
    ("gather_mlp", GDIMS, {"variant": "vmap"}, "variant")])
def test_explicit_infeasible_knob_raises(kernel, dims, knob, match):
    """A forced knob that does not fit raises, on the CPU too (the plan is
    resolved before the plain version runs)."""
    with pytest.raises(ValueError, match=match):
        _run(kernel, _operands(kernel, dims), **knob)


def test_bypass_disables_lookup_and_capture_sees_resolved_plans():
    plans.active_store().record("gather_mlp", GDIMS, _entry(rows=128),
                                device="cpu")
    args = _operands("gather_mlp", GDIMS)
    with plans.capture() as cap, plans.bypass():
        assert not plans.enabled()
        _run("gather_mlp", args)
    assert plans.enabled()
    assert [r["plan"]["provenance"] for r in cap] == ["heuristic"]
    assert cap[0]["kernel"] == "gather_mlp" and cap[0]["dims"] == GDIMS
    with plans.capture() as cap:
        _run("gather_mlp", args)
    assert cap[0]["plan"]["provenance"] == "autotuned"


def test_store_change_clears_the_memo():
    """Each call's plan is memoised; recording an entry must clear the
    memo, so the next call resolves it."""
    args = _operands("hub_reuse", HDIMS)
    with plans.capture() as cap:
        _run("hub_reuse", args)
        _run("hub_reuse", args)
        plans.active_store().record("hub_reuse", HDIMS, _entry(chunk=64),
                                    device="cpu")
        _run("hub_reuse", args)
    assert [r["plan"]["provenance"] for r in cap] == [
        "heuristic", "heuristic", "autotuned"]


# ---- tiling: the kernels' formulas ----------------------------------------

@pytest.mark.parametrize("k,d,dc,h,f", [(32, 65, 1, 64, 128),
                                        (64, 129, 1, 128, 256),
                                        (20, 256, 256, 512, 256),
                                        (32, 131, 1, 512, 256)])
def test_tiling_route_and_plan_as_the_wrapper_gives_them(k, d, dc, h, f):
    from repro_torch.kernels.gather_mlp import ops
    assert ops.route(k, d, dc, h, f) == tiling.route(k, d, dc, h, f)
    way = tiling.route(k, d, dc, h, f)
    assert tiling.narrow_smem(64, k, d, dc, h, f) <= tiling.MAX_SMEM \
        or way == "wide"
    if way == "wide":
        base = tiling.wide_plan(2, 128, k, d, dc, h, f, SMS)
        assert ops.wide_plan(2, 128, k, d, dc, h, f, sms=SMS) == base
        assert tiling.wide_plan(2, 128, k, d, dc, h, f, SMS,
                                base["nsplit"]) == base
        assert tiling.gather_mlp_smem(2, 128, k, d, dc, h, f, SMS) == \
            base["smem"]


# ---- autotune_cell ---------------------------------------------------------

@pytest.mark.parametrize("kernel,dims", [("gather_mlp", GDIMS),
                                         ("hub_reuse", HDIMS),
                                         ("gather_mlp", WDIMS)])
def test_same_seed_and_timer_pick_same_winner(kernel, dims):
    s1, s2 = plans.PlanStore(), plans.PlanStore()
    e1 = autotune.autotune_cell(kernel, dims, seed=3, store=s1,
                                timer=cost_model, device="cpu", sms=SMS)
    e2 = autotune.autotune_cell(kernel, dims, seed=3, store=s2,
                                timer=cost_model, device="cpu", sms=SMS)
    assert e1 == e2 and s1.entries == s2.entries


@pytest.mark.parametrize("kernel,dims", [("gather_mlp", GDIMS),
                                         ("hub_reuse", HDIMS),
                                         ("gather_mlp", WDIMS)])
def test_winner_minimizes_cost_and_records_context(kernel, dims):
    store = plans.PlanStore()
    entry = autotune.autotune_cell(kernel, dims, store=store,
                                   timer=cost_model, device="cpu", sms=SMS)
    cands = autotune.candidate_plans(kernel, dims, sms=SMS)
    batched = [c for c in cands if "variant" not in c]
    best = min(cost_model(None, c) for c in batched)
    assert cost_model(None, plans.knobs(kernel, entry)) == best
    assert entry["provenance"] == "autotuned"
    assert entry["heuristic"] == cands[0]
    assert entry["heuristic_ms"] == cost_model(None, cands[0])
    assert entry["per_cloud_ms"] == 1000.0
    assert entry["searched"] == len(cands)
    assert entry["device"] == "cpu"
    for row in entry["candidates"]:     # the plain version: all bit-equal
        assert row["bit_equal"] and row["max_diff"] == 0.0
        assert row["rejected"] is None and row["smem_library"] is None
    assert store.lookup(kernel, device="cpu", **dims) == entry


@pytest.mark.parametrize("kernel,dims", [("gather_mlp", GDIMS),
                                         ("hub_reuse", HDIMS),
                                         ("hub_reuse", dict(HDIMS, c=128)),
                                         ("gather_mlp", WDIMS)])
def test_candidates_feasible_deduped_heuristic_first(kernel, dims):
    cands = autotune.candidate_plans(kernel, dims, sms=SMS)
    assert cands[0] == autotune.heuristic_knobs(kernel, dims, SMS)
    assert cands[-1] == {"variant": "per_cloud"}
    sigs = [autotune._launch_sig(kernel, dims, c, SMS) for c in cands]
    assert len(set(sigs)) == len(sigs)                # deduplicated
    for c in cands:
        assert tiling.feasible(kernel, dims, plans.knobs(kernel, c))
    knob = tiling.knobs_of(kernel, dims)[0]
    assert {knob} == {k for c in cands[:-1] for k in c}
    assert len(autotune.candidate_plans(kernel, dims, 1, sms=SMS)) == 2


def test_candidates_follow_what_each_launches():
    """One 64-row chunk at C <= 64 whatever the knob; at C = 128, chunk =
    64 is two launches and a candidate of its own."""
    assert autotune.candidate_plans("hub_reuse", dict(HDIMS, c=64),
                                    sms=SMS)[:-1] == [{"chunk": 128}]
    assert autotune.candidate_plans("hub_reuse", dict(HDIMS, c=128),
                                    sms=SMS)[:-1] == [{"chunk": 128},
                                                      {"chunk": 64}]


def test_ensure_plan_hits_do_not_retune():
    store, calls = plans.PlanStore(), []

    def counting_timer(call, knobs):
        calls.append(knobs)
        return cost_model(call, knobs)

    e1 = autotune.ensure_plan("gather_mlp", GDIMS, store=store,
                              timer=counting_timer, device="cpu", sms=SMS)
    n_timed = len(calls)
    assert n_timed > 0
    e2 = autotune.ensure_plan("gather_mlp", GDIMS, store=store,
                              timer=counting_timer, device="cpu", sms=SMS)
    assert len(calls) == n_timed and e2 == e1


def test_tuner_needs_a_card(tmp_path):
    """The tuner defaults to the card and raises without one: no CPU
    timing, and the CLI writes no store."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is here")
    with pytest.raises(RuntimeError, match="CUDA"):
        autotune.measure(lambda: None)
    with pytest.raises(RuntimeError, match="CUDA"):
        autotune.autotune_cell("gather_mlp", GDIMS, timer=cost_model)
    out = tmp_path / "plans.json"
    with pytest.raises(RuntimeError, match="CUDA"):
        autotune.main(["--models", "pointnet2_c", "--batches", "2",
                       "--out", str(out)])
    assert not out.exists()


# ---- the per-cloud variant -------------------------------------------------

@pytest.mark.parametrize("kernel,dims", [("hub_reuse", HDIMS),
                                         ("gather_mlp", GDIMS)])
def test_per_cloud_promoted_when_batched_loses(kernel, dims):
    store = plans.PlanStore()
    entry = autotune.autotune_cell(kernel, dims, store=store,
                                   timer=per_cloud_wins, device="cpu",
                                   sms=SMS)
    assert entry["variant"] == "per_cloud"
    assert entry["measured_ms"] == 1.0 < entry["batched_ms"]
    assert plans.entry_error(kernel, entry) is None
    assert store.lookup(kernel, device="cpu", **dims) == entry
    e2 = autotune.autotune_cell(kernel, dims, store=plans.PlanStore(),
                                timer=per_cloud_wins, device="cpu", sms=SMS)
    assert e2 == entry


def test_layered_cell_records_only_a_per_cloud_win():
    """A hub_reuse cell on the layered route (C past 128) has no knob:
    its heuristic is its only batched candidate, a batched win records
    nothing, a per-cloud win records the per_cloud entry."""
    dims = dict(HDIMS, c=200)
    assert autotune.candidate_plans("hub_reuse", dims, sms=SMS) == [
        {}, {"variant": "per_cloud"}]
    store = plans.PlanStore()
    entry = autotune.autotune_cell("hub_reuse", dims, store=store,
                                   timer=cost_model, device="cpu", sms=SMS)
    assert plans.knobs("hub_reuse", entry) == {} and not store.entries
    entry = autotune.autotune_cell(
        "hub_reuse", dims, store=store, device="cpu", sms=SMS,
        timer=lambda call, knobs: 1.0 if "variant" in knobs else 5.0)
    assert store.lookup("hub_reuse", device="cpu", **dims) == entry
    assert entry["variant"] == "per_cloud"


def test_per_cloud_entries_round_trip_and_validate(tmp_path):
    store = plans.PlanStore()
    store.record("hub_reuse", HDIMS, _entry(variant="per_cloud"),
                 device="cpu")
    store.record("gather_mlp", GDIMS, _entry(variant="per_cloud"),
                 device="cpu")
    loaded = plans.PlanStore.load(store.save(str(tmp_path / "p.json")))
    assert loaded.entries == store.entries


@pytest.mark.parametrize("kernel,dims", [("hub_reuse", HDIMS),
                                         ("gather_mlp", GDIMS)])
def test_per_cloud_entry_dispatches_with_unchanged_numerics(kernel, dims):
    args = _operands(kernel, dims)
    base = _run(kernel, args)
    plans.active_store().record(kernel, dims, _entry(variant="per_cloud"),
                                device="cpu")
    with plans.capture() as cap:
        out = _run(kernel, args)
    assert cap[-1]["plan"]["variant"] == "per_cloud"
    assert cap[-1]["plan"]["provenance"] == "autotuned"
    assert torch.equal(out, base)


# ---- the engine ------------------------------------------------------------

@pytest.mark.parametrize("kw,match", [
    ({"ts": 8}, "TPU tile knobs"), ({"th": 2}, "TPU tile knobs"),
    ({"lanes": 128}, "TPU tile knobs"),
    ({"vmem_budget_mb": 8.0}, "TPU tile knobs"),
    ({"dimension_semantics": ["parallel", "arbitrary"]}, "TPU tile knobs"),
    ({"row": 64}, "unknown kernel_kw"), ({"rows": 96}, r"\(64, 128\)"),
    ({"chunk": True}, r"\(64, 128\)"), ({"nsplit": 0}, "positive")])
def test_kernel_kw_validated(kw, match):
    with pytest.raises(ValueError, match=match):
        archs.EngineCtx.make(kernel_kw=kw)
    with pytest.raises(ValueError, match=match):
        engine.PCNEngine(SPEC, fc_backend="cuda", kernel_kw=kw,
                         device="cpu")
    if "TPU" in match:
        with pytest.raises(ValueError, match="rows.*nsplit|nsplit.*rows"):
            archs.EngineCtx.make(kernel_kw=kw)


def test_kernel_kw_reaches_every_launch(params):
    """The engine's knobs force each launch of their route; the logits
    are bit-equal to the heuristic's (the plain version on the CPU)."""
    b = _batch()
    base = engine.apply(params, b, spec=SPEC, fc_backend="cuda",
                        device="cpu")
    eng = engine.PCNEngine(SPEC, fc_backend="cuda",
                           kernel_kw={"rows": 64, "chunk": 64},
                           device="cpu")
    with plans.capture() as cap:
        out = eng.apply(params, b)
    assert len(cap) == 2 * len(SPEC.blocks)
    for rec in cap:
        assert rec["plan"]["provenance"] == "override"
        knob = "rows" if rec["kernel"] == "gather_mlp" else "chunk"
        assert rec["plan"][knob] == 64
    assert torch.equal(out, base)
    # the fallback engine of the server takes the primary's knobs
    from repro_torch.serve import BucketSet, PCNServer
    srv = PCNServer(eng, params, BucketSet.make([160], batch=2),
                    fallback="reference", warmup=False)
    srv._fallback_callable_for(srv.buckets.buckets[0])
    assert srv._fallback_engine.kernel_kw == {"rows": 64, "chunk": 64}


def test_model_cells_match_the_forwards_calls(params):
    """model_cells sees exactly the calls the forward's FC makes: both
    kernels a block in lpcn mode, gather_mlp alone in traditional."""
    for mode, kernels in (("lpcn", ["hub_reuse", "gather_mlp"]),
                          ("traditional", ["gather_mlp"])):
        cells = autotune.model_cells(SPEC, 2, 96, mode=mode, device="cpu")
        assert [k for k, _ in cells] == kernels * len(SPEC.blocks)
        rng = np.random.default_rng(0)
        xyz = np.stack([make_cloud(rng, 96) for _ in range(2)])
        from repro_torch import random
        b = engine.Batch.make(xyz, key=random.PRNGKey(0, "cpu"),
                              device="cpu")
        with plans.capture() as cap:
            engine.apply(engine.init(SPEC, 0, "cpu"), b, spec=SPEC,
                         mode=mode, fc_backend="cuda", device="cpu")
        assert cells == [(r["kernel"], r["dims"]) for r in cap]
        assert all(d["b"] == 2 for _, d in cells)


def test_autotuned_store_serves_engine_with_unchanged_numerics(params):
    b = _batch()
    base = engine.apply(params, b, spec=SPEC, fc_backend="cuda",
                        device="cpu")
    entries = autotune.autotune_model(SPEC, len(SIZES), max(SIZES),
                                      store=plans.active_store(),
                                      timer=per_cloud_wins, device="cpu",
                                      sms=SMS)
    assert entries and all(e["variant"] == "per_cloud" for e in entries)
    with plans.capture() as cap:
        out = engine.apply(params, b, spec=SPEC, fc_backend="cuda",
                           device="cpu")
    assert cap and all(r["plan"]["provenance"] == "autotuned"
                       and r["plan"]["variant"] == "per_cloud" for r in cap)
    assert torch.equal(out, base)


def test_per_cloud_backend_matches_jax_pallas_vmap(params):
    """fc_backend="cuda_per_cloud" (per-cloud launches; the plain version
    here) against JAX's "pallas_vmap" (per-cloud Pallas kernels in
    interpret mode) on a padded batch with an empty fill cloud, and
    against the port's batched "cuda" backend."""
    from functools import partial
    import jax
    from repro import engine as jengine
    from repro.models import pointnet2 as jpointnet2
    jspec = replace(jpointnet2.POINTNET2_C,
                    blocks=tuple(jengine.BlockSpec(*b) for b in BLOCKS),
                    global_mlp=(32, 64), head_dims=(32,), n_classes=10)
    rng = np.random.default_rng(0)
    clouds = [np.asarray(make_cloud(rng, n), np.float32) if n
              else np.zeros((0, 3), np.float32) for n in SIZES]
    keys = jax.random.split(jax.random.PRNGKey(1), len(SIZES))
    jp = jengine.init(jax.random.PRNGKey(0), jspec)
    jp = jax.tree.map(lambda a: a + 0.05 if a.ndim == 1 else a, jp)
    tp = engine.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    jb = jengine.Batch.from_clouds(clouds, key=keys)
    tb = engine.Batch.from_clouds(clouds, key=np.asarray(keys),
                                  device="cpu")
    want = np.asarray(jax.jit(partial(
        jengine.apply, spec=jspec, mode="lpcn",
        fc_backend="pallas_vmap"))(jp, jb))
    with plans.capture() as cap:
        got = engine.apply(tp, tb, spec=SPEC, fc_backend="cuda_per_cloud",
                           device="cpu")
    assert {r["plan"]["variant"] for r in cap} == {"per_cloud"}
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    batched = engine.apply(tp, tb, spec=SPEC, fc_backend="cuda",
                           device="cpu")
    assert torch.equal(got, batched)


def test_serve_cli_takes_kernel_kw(tmp_path):
    from repro_torch.launch import serve
    out = tmp_path / "trace.json"
    serve.main(["--arch", "pointnet2_c", "--reduced", "--points", "128",
                "--batch", "2", "--trace", "4", "--rate", "100",
                "--device", "cpu", "--serve-json", str(out),
                "--kernel-kw", '{"rows": 64, "chunk": 64}'])
    rep = json.loads(out.read_text())
    assert rep["answered"] == 4 and not any(rep["faults"].values())
    assert "kernel_kw={'rows': 64, 'chunk': 64}" in rep["engine"]
    with pytest.raises(ValueError, match="TPU tile knobs"):
        serve.main(["--arch", "pointnet2_c", "--reduced", "--points", "64",
                    "--batch", "1", "--steps", "1", "--device", "cpu",
                    "--kernel-kw", '{"ts": 8}'])


# ---- on the card -----------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# the main path's cells at B = 8 and B = 2, a narrow shape that takes
# only 64-row tiles, and a wide one
CARD_CELLS = (
    ("gather_mlp", dict(b=8, s=512, k=32, d=65, dc=1, h=64, f=128)),
    ("gather_mlp", dict(b=2, s=128, k=64, d=129, dc=1, h=128, f=256)),
    ("gather_mlp", dict(b=2, s=64, k=32, d=192, dc=3, h=192, f=256)),
    ("gather_mlp", dict(b=2, s=128, k=32, d=131, dc=1, h=512, f=256)),
    ("hub_reuse", dict(b=8, hn=16, c=64, m=64, k=32, d=64, h=64, f=128)),
    ("hub_reuse", dict(b=2, hn=4, c=128, m=64, k=64, d=128, h=128, f=256)),
    ("hub_reuse", dict(b=2, hn=4, c=256, m=64, k=64, d=128, h=128, f=256)))


@pytest.mark.cuda
def test_forced_knobs_match_the_heuristic_on_card():
    """Each forced knob against the heuristic's launch: rows and chunk
    bit-equal, nsplit within 1e-4; tiling.py's shared memory equal to the
    library's for every candidate; per_cloud bit-equal too, but on the
    wide route, where the heuristic's H split at B = 1 may differ (within
    1e-4 there)."""
    dev = _card()
    sms = autotune.card_sms(dev)
    for kernel, dims in CARD_CELLS:
        args = autotune.synth_cell_args(kernel, dims, seed=1, device=dev)
        base = autotune.cell_call(kernel, args, {})()
        for knobs in autotune.candidate_plans(kernel, dims, sms=sms):
            out = autotune.cell_call(kernel, args, knobs)()
            err, lim, same = autotune.compare(out, base)
            ours, lib = autotune.smem_counts(kernel, dims, knobs, sms, dev)
            assert ours == lib, (kernel, dims, knobs)
            if tiling.knobs_of(kernel, dims) == ("nsplit",):
                assert err <= lim, (kernel, dims, knobs, err)
            else:
                assert same, (kernel, dims, knobs, err)


@pytest.mark.cuda
def test_infeasible_forced_rows_raises_on_card():
    dev = _card()
    dims = dict(b=2, s=64, k=32, d=192, dc=3, h=192, f=256)
    assert tiling.narrow_smem(128, 32, 192, 3, 192, 256) > tiling.MAX_SMEM
    from repro_torch.kernels.gather_mlp import ops
    assert ops.library_smem(*dims.values(), rows=128) == \
        tiling.narrow_smem(128, 32, 192, 3, 192, 256)
    args = autotune.synth_cell_args("gather_mlp", dims, device=dev)
    with pytest.raises(ValueError, match="shared memory"):
        autotune.cell_call("gather_mlp", args, {"rows": 128})()


@pytest.mark.cuda
def test_per_cloud_backend_matches_cuda_on_card():
    dev = _card()
    from repro_torch import kernels
    p = engine.init(SPEC, seed=0, device=dev)
    b = _batch().to(dev)
    want = engine.apply(p, b, spec=SPEC, fc_backend="cuda")
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    got = engine.apply(p, b, spec=SPEC, fc_backend="cuda_per_cloud")
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    n = len(SIZES) * len(SPEC.blocks)
    assert counts["gather_mlp"] == counts["hub_reuse"] == n, counts
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_autotune_cell_on_card_serves_the_next_forward():
    dev = _card()
    kernel, dims = CARD_CELLS[0]
    entry = autotune.autotune_cell(kernel, dims, reps=2, device=dev)
    name = torch.cuda.get_device_name(dev)
    assert entry["device"] == name
    assert plans.store_key(kernel, dims, dev) in plans.active_store().entries
    assert plans.store_key(kernel, dims, dev).startswith(name + "|")
    args = autotune.synth_cell_args(kernel, dims, device=dev)
    with plans.capture() as cap:
        autotune.cell_call(kernel, args, {})()
    assert cap[-1]["plan"]["provenance"] == "autotuned"
