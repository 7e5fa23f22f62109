"""The port's serving layer (``repro_torch.serve``) on the CPU, mirroring
``tests/test_serve.py`` on both FC backends ("cuda" routes to the plain
versions on CPU tensors): bucket policy, admission, dispatch triggers,
exactly-once responses equal to ``apply_single``, one warm-up per bucket,
the metrics report, the hardened-failure layer and async dispatch — plus
the same request stream through the JAX ``repro.serve.PCNServer`` and the
port's, and the kernel loader under threads.

``test_rejects_buckets_not_dividing_mesh`` has no counterpart here: the
port's engine has no mesh (ROADMAP queue 1 item 8).  The JAX compile-once
tests become warmed-bucket counts (``PCNEngine.compile_count``)."""
import sys
import threading
import time
from dataclasses import replace
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro import engine as jengine
from repro import serve as jserve
from repro.models import pointnet2 as jpointnet2
from repro_torch import engine, random, serve
from repro_torch.data.synthetic import make_cloud
from repro_torch.engine import BlockSpec
from repro_torch.kernels import _build
from repro_torch.models import pointnet2
from repro_torch.serve import (AdmissionError, Bucket, BucketSet, FaultPlan,
                               PCNServer, QueueFullError, RequestError,
                               ServeMetrics, UnknownRequestError,
                               ValidationError, percentile_summary,
                               synthetic_trace)
from repro_torch.serve.queue import key_data

torch.set_num_threads(1)

BLOCKS = ((24, 8, (16, 32)), (8, 8, (32, 48)))
SPEC = replace(pointnet2.POINTNET2_C,
               blocks=tuple(BlockSpec(*b) for b in BLOCKS))
BUCKETS = BucketSet.make([64, 96], batch=2)
TOL = 1e-5                                  # eager paths (ROADMAP)


class FakeClock:
    """Deterministic clock so timeout policy is testable without sleeps."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _with_biases(params):
    """Nonzero biases, so a bias handled wrongly shows."""
    for mlp in (*params.blocks, params.global_mlp, params.head):
        for layer in mlp.layers:
            layer.b.add_(0.05)
    return params


@pytest.fixture(scope="module", params=["reference", "cuda"])
def eng_params(request):
    eng = engine.PCNEngine(SPEC, mode="lpcn", fc_backend=request.param,
                           device="cpu")
    return eng, _with_biases(eng.init(seed=0))


def _cloud(n, seed=0):
    return make_cloud(np.random.default_rng(seed), n)


def _ref(eng, params, cloud, key):
    return eng.apply_single(params, cloud, key=key).numpy()


# ---- bucket policy ----------------------------------------------------------

def test_bucket_for_picks_tightest():
    bs = BucketSet.make([64, 96, 128], batch=4)
    assert bs.bucket_for(1).n_points == 64
    assert bs.bucket_for(64).n_points == 64
    assert bs.bucket_for(65).n_points == 96
    assert bs.bucket_for(128).n_points == 128


def test_bucket_admission_errors():
    bs = BucketSet.make([64], batch=4)
    with pytest.raises(AdmissionError, match="largest bucket is 64"):
        bs.bucket_for(65)
    with pytest.raises(AdmissionError, match="n >= 1"):
        bs.bucket_for(0)
    with pytest.raises(ValueError, match="duplicate bucket"):
        BucketSet.make([64, 64], batch=4)


def test_bucket_plan_quantiles_aligned():
    sizes = [50] * 90 + [500] * 10
    bs = BucketSet.plan(sizes, n_buckets=2, batch=4, align=64)
    assert all(b.n_points % 64 == 0 for b in bs)
    assert bs.max_points >= 500
    assert bs.buckets[0].n_points >= 50


# ---- dispatch policy --------------------------------------------------------

def test_batch_full_fires_immediately(eng_params):
    eng, params = eng_params
    srv = PCNServer(eng, params, BUCKETS, timeout_s=10.0, clock=FakeClock(),
                    sync=True)
    r0 = srv.submit(_cloud(60, 0))
    assert not srv.ready(r0) and srv.pending() == 1
    r1 = srv.submit(_cloud(50, 1))       # same 64-bucket: batch full
    assert srv.ready(r0) and srv.ready(r1) and srv.pending() == 0
    assert srv.metrics.dispatches[-1].partial is False


def test_timeout_fires_partial_no_starvation(eng_params):
    eng, params = eng_params
    clock = FakeClock()
    srv = PCNServer(eng, params, BUCKETS, timeout_s=0.5, clock=clock,
                    sync=True)
    rid = srv.submit(_cloud(80, 2))      # 96-bucket, alone
    assert srv.poll() == []
    clock.advance(0.49)
    assert srv.poll() == []
    clock.advance(0.02)
    assert srv.poll() == [rid]           # due: partial batch fires
    d = srv.metrics.dispatches[-1]
    assert d.partial and d.n_requests == 1 and d.bucket == (2, 96)
    assert srv.metrics.requests[-1].queue_wait_s == pytest.approx(0.51)


def test_fifo_within_bucket(eng_params):
    eng, params = eng_params
    srv = PCNServer(eng, params, BUCKETS, timeout_s=10.0, clock=FakeClock(),
                    sync=True)
    rids = [srv.submit(_cloud(40, s)) for s in range(3)]
    assert srv.ready(rids[0]) and srv.ready(rids[1])
    assert not srv.ready(rids[2]) and srv.pending() == 1
    assert srv.drain() == [rids[2]]


def test_admission_rejects_bad_requests(eng_params):
    eng, params = eng_params
    srv = PCNServer(eng, params, BUCKETS, timeout_s=1.0, clock=FakeClock())
    with pytest.raises(AdmissionError, match="largest bucket"):
        srv.submit(_cloud(97))
    with pytest.raises(AdmissionError, match="n >= 1"):
        srv.submit(np.zeros((0, 3), np.float32))
    with pytest.raises(AdmissionError, match=r"\(N, 3\)"):
        srv.submit(np.zeros((4, 2), np.float32))
    assert srv.pending() == 0


def test_exactly_once_and_equivalence(eng_params):
    """Every admitted request is answered exactly once, equal to
    apply_single on its own cloud and key — including requests of a
    timeout-fired partial batch (fill rows are fully masked)."""
    eng, params = eng_params
    clock = FakeClock()
    srv = PCNServer(eng, params, BUCKETS, timeout_s=0.1, clock=clock,
                    sync=True)
    sizes = (60, 90, 33, 64, 72)
    clouds = [_cloud(n, seed=10 + i) for i, n in enumerate(sizes)]
    keys = [random.PRNGKey(100 + i) for i in range(len(sizes))]
    rids = [srv.submit(c, key=k) for c, k in zip(clouds, keys)]
    clock.advance(1.0)
    srv.poll()
    assert srv.pending() == 0
    assert srv.metrics.report()["partial_batches"] >= 1
    for rid, cloud, key in zip(rids, clouds, keys):
        got = srv.take(rid)
        assert isinstance(got, np.ndarray) and got.shape == (40,)
        np.testing.assert_allclose(got, _ref(eng, params, cloud, key),
                                   rtol=TOL, atol=TOL)
        with pytest.raises(KeyError):
            srv.take(rid)


# ---- one warm-up per bucket (the compile-once tests) ------------------------

def test_warms_once_per_bucket(eng_params):
    """A ragged trace spanning both buckets warms each bucket once, at
    construction, whatever the n_valid mix; the report records it."""
    backend = eng_params[0].fc_backend
    eng = engine.PCNEngine(SPEC, fc_backend=backend, device="cpu")
    params = eng.init(seed=1)
    assert eng.compile_count == 0
    clock = FakeClock()
    srv = PCNServer(eng, params, BUCKETS, timeout_s=0.1, clock=clock)
    assert eng.compile_count == len(BUCKETS)
    rng = np.random.default_rng(3)
    for n in (40, 64, 90, 17, 96, 65, 1, 50):
        srv.submit(_cloud(int(n), seed=int(rng.integers(1 << 30))))
        clock.advance(0.2)
        srv.poll()
    srv.drain()
    assert srv.pending() == 0
    assert {r.bucket for r in srv.metrics.requests} == {(2, 64), (2, 96)}
    assert eng.compile_count == len(BUCKETS)
    assert srv.report()["compile_count"] == len(BUCKETS)


def test_lazy_warmup_warms_on_first_use(eng_params):
    backend = eng_params[0].fc_backend
    eng = engine.PCNEngine(SPEC, fc_backend=backend, device="cpu")
    params = eng.init(seed=2)
    srv = PCNServer(eng, params, BUCKETS, timeout_s=10.0, clock=FakeClock(),
                    warmup=False, sync=True)
    assert eng.compile_count == 0
    for s in range(2):
        srv.submit(_cloud(60, seed=20 + s))       # fills the 64-bucket
    assert eng.compile_count == 1


# ---- metrics ----------------------------------------------------------------

def test_percentile_summary_monotone():
    lat = percentile_summary(list(range(1, 101)))
    assert lat["p50"] <= lat["p95"] <= lat["p99"] <= lat["max"]
    assert percentile_summary([]) == {"p50": 0.0, "p95": 0.0, "p99": 0.0,
                                      "mean": 0.0, "max": 0.0}


def test_padding_waste_accounting():
    m = ServeMetrics()
    b = Bucket(2, 100)
    m.record_dispatch(b, [(0, 60, 0.0), (1, 40, 0.0)], 1.0, 2.0)
    m.record_dispatch(b, [(2, 50, 0.5)], 1.0, 2.0)
    rep = m.report()
    assert rep["requests"] == 3 and rep["dispatches"] == 2
    assert rep["full_batches"] == 1 and rep["partial_batches"] == 1
    assert rep["padding_waste_pct"] == pytest.approx(
        100.0 * (1 - 150 / 400))
    assert rep["per_bucket"]["2x100"] == {
        "dispatches": 2, "partial": 1, "requests": 3, "degraded": 0}
    rec = [r for r in m.requests if r.rid == 2][0]
    assert rec.queue_wait_s == pytest.approx(0.5)
    assert rec.e2e_s == pytest.approx(1.5)


def test_report_keys_match_jax():
    """The port's report has the JAX report's keys, section by section."""
    reps = []
    for mod in (serve, jserve):
        m = mod.ServeMetrics()
        m.record_dispatch(mod.Bucket(2, 100), [(0, 60, 0.0)], 1.0, 2.0)
        reps.append(m.report())
    assert reps[0].keys() == reps[1].keys()
    for k in ("latency_ms", "overlap", "faults"):
        assert reps[0][k].keys() == reps[1][k].keys()
    assert reps[0] == reps[1]


# ---- admission guard --------------------------------------------------------

def test_validation_rejects_poisoned_clouds(eng_params):
    eng, params = eng_params
    srv = PCNServer(eng, params, BUCKETS, timeout_s=1.0, clock=FakeClock())
    bad = _cloud(50)
    bad[3, 1] = np.nan
    with pytest.raises(ValidationError, match="non-finite"):
        srv.submit(bad)
    inf = _cloud(50)
    inf[0, 0] = np.inf
    with pytest.raises(ValidationError, match="non-finite"):
        srv.submit(inf)
    with pytest.raises(ValidationError, match="not a floating point"):
        srv.submit(np.zeros((10, 3), np.int32))
    assert srv.pending() == 0
    assert srv.report()["faults"]["rejected_invalid"] == 3


def test_validation_coerces_float64(eng_params):
    eng, params = eng_params
    clock = FakeClock()
    srv = PCNServer(eng, params, BUCKETS, timeout_s=0.1, clock=clock)
    key = random.PRNGKey(5)
    rid = srv.submit(_cloud(40, 3).astype(np.float64), key=key)
    clock.advance(1.0)
    srv.poll()
    np.testing.assert_allclose(srv.take(rid),
                               _ref(eng, params, _cloud(40, 3), key),
                               rtol=TOL, atol=TOL)


def test_bounded_lane_sheds_on_full_fifo(eng_params):
    eng, params = eng_params
    srv = PCNServer(eng, params, BucketSet.make([64], batch=4),
                    timeout_s=100.0, clock=FakeClock(), max_lane_depth=2)
    r0 = srv.submit(_cloud(30, 0))
    r1 = srv.submit(_cloud(30, 1))
    with pytest.raises(QueueFullError, match="lane is full"):
        srv.submit(_cloud(30, 2))
    with pytest.raises(QueueFullError):
        srv.submit(_cloud(30, 3))
    assert srv.pending() == 2
    assert srv.drain() == [r0, r1]
    assert srv.ready(r0) and srv.ready(r1)
    rep = srv.report()
    assert rep["faults"]["shed_queue_full"] == 2
    assert rep["requests"] == 2


# ---- exactly-once bookkeeping -----------------------------------------------

def test_take_unknown_rid_diagnosis(eng_params):
    eng, params = eng_params
    srv = PCNServer(eng, params, BUCKETS, timeout_s=10.0, clock=FakeClock())
    with pytest.raises(UnknownRequestError, match="never submitted"):
        srv.take(123)
    rid = srv.submit(_cloud(40, 1))
    with pytest.raises(KeyError):
        srv.take(rid)
    with pytest.raises(UnknownRequestError, match="still pending"):
        srv.take(rid)
    srv.drain()
    srv.take(rid)
    with pytest.raises(UnknownRequestError, match="already taken"):
        srv.take(rid)


# ---- fault isolation --------------------------------------------------------

def test_injected_failure_isolated_and_degraded(eng_params):
    eng, params = eng_params
    plan = FaultPlan.parse("fail@1")
    srv = PCNServer(eng, params, BUCKETS, timeout_s=0.1, clock=FakeClock(),
                    faults=plan, sync=True)
    keys = [random.PRNGKey(100 + i) for i in range(6)]
    clouds = [_cloud(60, 30 + i) for i in range(6)]
    rids = [srv.submit(c, key=k) for c, k in zip(clouds, keys)]
    assert srv.pending() == 0
    assert plan.injected == [(1, "fail")]
    for rid, c, k in zip(rids, clouds, keys):
        np.testing.assert_allclose(srv.take(rid), _ref(eng, params, c, k),
                                   rtol=TOL, atol=TOL)
    rep = srv.report()
    assert rep["faults"]["degraded_dispatches"] == 1
    assert rep["faults"]["failed_requests"] == 0
    assert rep["per_bucket"]["2x64"]["degraded"] == 1
    # the fallback engine runs the plain path on the primary's device
    assert srv._fallback_engine.fc_backend == "reference"
    assert srv._fallback_engine.device == eng.device


def test_nan_poisoned_output_detected(eng_params):
    eng, params = eng_params
    srv = PCNServer(eng, params, BUCKETS, timeout_s=0.1, clock=FakeClock(),
                    faults=FaultPlan.parse("nan@0"))
    key = random.PRNGKey(7)
    rid0 = srv.submit(_cloud(50, 40), key=key)
    srv.submit(_cloud(50, 41))           # fills the batch -> fires
    got = srv.take(rid0)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, _ref(eng, params, _cloud(50, 40), key),
                               rtol=TOL, atol=TOL)
    assert srv.report()["faults"]["degraded_dispatches"] == 1


def test_nan_fault_poisons_on_the_outputs_device():
    out = torch.ones(2, 3)
    got = FaultPlan.parse("nan@0").wrap(lambda b: out)(None)
    assert isinstance(got, torch.Tensor) and got.device == out.device
    assert torch.isnan(got).all() and torch.equal(out, torch.ones(2, 3))


def test_failure_without_fallback_surfaces_request_error(eng_params):
    eng, params = eng_params
    srv = PCNServer(eng, params, BUCKETS, timeout_s=0.1, clock=FakeClock(),
                    faults=FaultPlan.parse("fail@0"), fallback=None,
                    sync=True)
    r0 = srv.submit(_cloud(50, 0))
    r1 = srv.submit(_cloud(50, 1))
    r2 = srv.submit(_cloud(50, 2))
    r3 = srv.submit(_cloud(50, 3))
    assert srv.pending() == 0
    assert srv.ready(r0) and srv.failed(r0) and srv.failed(r1)
    assert not srv.failed(r2) and not srv.failed(r3)
    with pytest.raises(RequestError, match="engine") as ei:
        srv.take(r0)
    assert ei.value.rid == r0 and ei.value.bucket == (2, 64)
    assert "InjectedFault" in ei.value.cause
    assert not ei.value.degraded_attempted
    with pytest.raises(RequestError):
        srv.take(r1)
    with pytest.raises(UnknownRequestError, match="already taken"):
        srv.take(r0)
    assert np.isfinite(srv.take(r2)).all()
    rep = srv.report()
    assert rep["faults"]["failed_dispatches"] == 1
    assert rep["faults"]["failed_requests"] == 2


def test_breaker_opens_and_half_open_probe(eng_params):
    eng, params = eng_params
    clock = FakeClock()
    plan = FaultPlan.parse("fail@0,fail@1")
    srv = PCNServer(eng, params, BucketSet.make([64], batch=2),
                    timeout_s=0.1, clock=clock, faults=plan,
                    breaker_fail_streak=2, breaker_cooldown_s=5.0,
                    sync=True)
    br = srv.breakers[(2, 64)]
    for i in range(4):
        srv.submit(_cloud(30, i))
    assert br.state == "open" and br.open_count == 1
    assert srv.report()["faults"]["breaker_opened"] == 1
    step_before = plan.step
    srv.submit(_cloud(30, 8))
    srv.submit(_cloud(30, 9))
    assert plan.step == step_before      # open: the primary untouched
    assert br.state == "open"
    clock.advance(6.0)
    srv.submit(_cloud(30, 10))
    srv.submit(_cloud(30, 11))
    assert plan.step == step_before + 1  # the probe ran the primary
    assert br.state == "closed" and br.failures == 0
    for rid in range(8):
        assert np.isfinite(srv.take(rid)).all()
    assert srv.report()["faults"]["degraded_dispatches"] == 3


def test_breaker_reopens_on_failed_probe(eng_params):
    eng, params = eng_params
    clock = FakeClock()
    srv = PCNServer(eng, params, BucketSet.make([64], batch=2),
                    timeout_s=0.1, clock=clock,
                    faults=FaultPlan.parse("fail@0,fail@1,fail@2"),
                    breaker_fail_streak=2, breaker_cooldown_s=5.0,
                    sync=True)
    br = srv.breakers[(2, 64)]
    for i in range(4):
        srv.submit(_cloud(30, i))
    assert br.state == "open"
    clock.advance(6.0)
    srv.submit(_cloud(30, 5))
    srv.submit(_cloud(30, 6))            # probe consumes fail@2 -> reopen
    assert br.state == "open" and br.open_count == 2


def test_circuit_open_without_fallback_fails_fast(eng_params):
    eng, params = eng_params
    plan = FaultPlan.parse("fail@0")
    srv = PCNServer(eng, params, BucketSet.make([64], batch=2),
                    timeout_s=0.1, clock=FakeClock(), faults=plan,
                    fallback=None, breaker_fail_streak=1,
                    breaker_cooldown_s=100.0, sync=True)
    srv.submit(_cloud(30, 0))
    srv.submit(_cloud(30, 1))            # breaker trips
    step_before = plan.step
    r2 = srv.submit(_cloud(30, 2))
    srv.submit(_cloud(30, 3))
    assert plan.step == step_before      # primary never called
    with pytest.raises(RequestError, match="circuit_open"):
        srv.take(r2)


# ---- deadlines --------------------------------------------------------------

def test_deadline_shed_at_poll(eng_params):
    eng, params = eng_params
    clock = FakeClock()
    srv = PCNServer(eng, params, BUCKETS, timeout_s=100.0, clock=clock,
                    deadline_s=1.0)
    r0 = srv.submit(_cloud(40, 0))
    clock.advance(0.5)
    r1 = srv.submit(_cloud(90, 1), deadline_s=10.0)
    clock.advance(1.0)
    assert r0 in srv.poll()
    with pytest.raises(RequestError, match="deadline"):
        srv.take(r0)
    assert srv.pending() == 1
    srv.drain()
    assert np.isfinite(srv.take(r1)).all()
    rep = srv.report()
    assert rep["faults"]["deadline_miss"] == 1
    assert rep["requests"] == 1


def test_drain_sheds_expired_and_clears_pending(eng_params):
    eng, params = eng_params
    clock = FakeClock()
    srv = PCNServer(eng, params, BUCKETS, timeout_s=100.0, clock=clock)
    srv.submit(_cloud(40, 0), deadline_s=0.5)
    srv.submit(_cloud(90, 1), deadline_s=0.5)
    clock.advance(1.0)
    srv.drain()
    assert srv.pending() == 0
    assert srv.report()["faults"]["deadline_miss"] == 2


# ---- chaos trace ------------------------------------------------------------

def _chaos_walk(eng, params, fallback):
    clock = FakeClock()
    plan = FaultPlan.bernoulli(seed=3, n_steps=8, p_fail=0.3)
    assert plan.events
    srv = PCNServer(eng, params, BUCKETS, timeout_s=0.1, clock=clock,
                    faults=plan, fallback=fallback, sync=True)
    sizes = (60, 90, 33, 64, 72, 96, 17, 50)
    clouds = [_cloud(n, seed=60 + i) for i, n in enumerate(sizes)]
    keys = [random.PRNGKey(200 + i) for i in range(len(sizes))]
    rids = []
    for c, k in zip(clouds, keys):
        rids.append(srv.submit(c, key=k))
        clock.advance(0.2)
        srv.poll()
    srv.drain()
    assert srv.pending() == 0
    return srv, plan, rids, clouds, keys


def test_chaos_trace_acceptance(eng_params):
    eng, params = eng_params
    srv, plan, rids, clouds, keys = _chaos_walk(eng, params, None)
    n_failed = 0
    for rid, c, k in zip(rids, clouds, keys):
        assert srv.ready(rid)
        if srv.failed(rid):
            n_failed += 1
            with pytest.raises(RequestError) as ei:
                srv.take(rid)
            assert ei.value.rid == rid and ei.value.reason == "engine"
        else:
            np.testing.assert_allclose(srv.take(rid),
                                       _ref(eng, params, c, k),
                                       rtol=TOL, atol=TOL)
    rep = srv.report()
    assert n_failed >= 1
    assert rep["faults"]["failed_requests"] == n_failed
    assert set(serve.FAULT_COUNTERS) <= set(rep["faults"])
    assert rep["fault_plan"]["injected"]
    assert FaultPlan.bernoulli(seed=3, n_steps=8, p_fail=0.3).events \
        == plan.events


def test_chaos_trace_with_fallback_answers_everything(eng_params):
    eng, params = eng_params
    srv, plan, rids, clouds, keys = _chaos_walk(eng, params, "reference")
    for rid, c, k in zip(rids, clouds, keys):
        np.testing.assert_allclose(srv.take(rid), _ref(eng, params, c, k),
                                   rtol=TOL, atol=TOL)
    rep = srv.report()
    assert rep["faults"]["degraded_dispatches"] >= 1
    assert rep["faults"]["failed_requests"] == 0


# ---- async in-flight dispatch ----------------------------------------------

def test_async_inflight_failure_resolves_request_error(eng_params):
    eng, params = eng_params
    srv = PCNServer(eng, params, BUCKETS, timeout_s=0.1, clock=FakeClock(),
                    faults=FaultPlan.parse("fail@0"), fallback=None)
    r0 = srv.submit(_cloud(50, 0))
    r1 = srv.submit(_cloud(50, 1))       # batch full -> fires in flight
    with pytest.raises(RequestError, match="engine") as ei:
        srv.take(r0)                     # blocks until completion
    assert ei.value.rid == r0 and "InjectedFault" in ei.value.cause
    with pytest.raises(RequestError):
        srv.take(r1)
    assert srv.pending() == 0
    rep = srv.report()
    assert rep["faults"]["failed_dispatches"] == 1
    assert rep["faults"]["failed_requests"] == 2
    srv.close()


def test_async_breaker_trips_at_completion(eng_params):
    eng, params = eng_params
    srv = PCNServer(eng, params, BucketSet.make([64], batch=2),
                    timeout_s=0.1, clock=FakeClock(),
                    faults=FaultPlan.parse("fail@0,fail@1"),
                    breaker_fail_streak=2, breaker_cooldown_s=5.0)
    rids = [srv.submit(_cloud(30, i)) for i in range(4)]
    srv.drain()
    br = srv.breakers[(2, 64)]
    assert br.state == "open" and br.open_count == 1
    rep = srv.report()
    assert rep["faults"]["breaker_opened"] == 1
    assert rep["faults"]["degraded_dispatches"] == 2
    for rid in rids:
        assert np.isfinite(srv.take(rid)).all()
    srv.close()


def test_async_deadline_expires_in_flight(eng_params):
    eng, params = eng_params
    clock = FakeClock()
    plan = FaultPlan.parse("slow@0:500", sleep=clock.advance)
    srv = PCNServer(eng, params, BUCKETS, timeout_s=0.1, clock=clock,
                    faults=plan)
    r0 = srv.submit(_cloud(50, 0), deadline_s=0.2)
    r1 = srv.submit(_cloud(50, 1), deadline_s=0.2)   # fires in flight
    srv.drain()
    for rid in (r0, r1):
        with pytest.raises(RequestError, match="deadline"):
            srv.take(rid)
    rep = srv.report()
    assert rep["faults"]["deadline_miss"] == 2
    assert rep["requests"] == 0
    srv.close()


def test_async_drain_quiescence_no_leaked_futures(eng_params):
    eng, params = eng_params
    srv = PCNServer(eng, params, BUCKETS, timeout_s=0.1, clock=FakeClock(),
                    max_in_flight=2)
    rids = [srv.submit(_cloud(40 + i, i)) for i in range(8)]
    srv.drain()
    assert srv.pending() == 0
    assert not srv._inflight and not srv._inflight_rids
    for rid in rids:
        assert srv.ready(rid)
        assert np.isfinite(srv.take(rid)).all()
    srv.close()
    assert srv._pool is None


def test_async_submit_overlaps_slow_inflight(eng_params):
    eng, params = eng_params
    release = threading.Event()
    plan = FaultPlan.parse("slow@0:1", sleep=lambda _dt: release.wait(10.0))
    srv = PCNServer(eng, params, BUCKETS, timeout_s=10.0, clock=FakeClock(),
                    faults=plan)
    r0 = srv.submit(_cloud(40, 0))
    srv.submit(_cloud(40, 1))            # 64-bucket fires, then stalls
    r2 = srv.submit(_cloud(90, 2))
    srv.submit(_cloud(90, 3))            # 96-bucket fires concurrently
    assert np.isfinite(srv.take(r2)).all()   # resolves during the stall
    assert not srv.ready(r0)
    release.set()
    srv.drain()
    assert np.isfinite(srv.take(r0)).all()
    assert srv.report()["overlap"]["inflight_depth_max"] >= 2
    srv.close()


def test_async_chaos_equivalence_multi_inflight(eng_params):
    eng, params = eng_params
    plan = FaultPlan.bernoulli(seed=7, n_steps=8, p_fail=0.2, p_nan=0.2)
    assert plan.events
    srv = PCNServer(eng, params, BUCKETS, timeout_s=10.0, clock=FakeClock(),
                    faults=plan, max_in_flight=4, breaker_fail_streak=99)
    sizes = (60, 50, 90, 70, 33, 64, 96, 40, 72, 55, 80, 44, 61, 91)
    clouds = [_cloud(n, seed=80 + i) for i, n in enumerate(sizes)]
    keys = [random.PRNGKey(300 + i) for i in range(len(sizes))]
    rids = [srv.submit(c, key=k) for c, k in zip(clouds, keys)]
    srv.drain()
    assert srv.pending() == 0
    for rid, c, k in zip(rids, clouds, keys):
        np.testing.assert_allclose(srv.take(rid), _ref(eng, params, c, k),
                                   rtol=TOL, atol=TOL)
    rep = srv.report()
    assert rep["faults"]["failed_requests"] == 0
    assert rep["faults"]["degraded_dispatches"] == len(plan.injected) >= 1
    assert rep["overlap"]["inflight_depth_max"] >= 1
    assert rep["dispatch_mode"] == "async" and rep["max_in_flight"] == 4
    srv.close()


def test_async_forwards_take_turns():
    """With several batches in flight, executor threads still run the
    engine's forward one at a time (concurrent forwards contend on the
    host; tools/serve_concurrency.py)."""
    eng = engine.PCNEngine(SPEC, fc_backend="cuda", device="cpu")
    params = eng.init(seed=3)
    srv = PCNServer(eng, params, BUCKETS, timeout_s=10.0, clock=FakeClock(),
                    max_in_flight=4)
    apply, lock, state = eng.apply, threading.Lock(), {"now": 0, "max": 0}

    def tracked(p, b):
        with lock:
            state["now"] += 1
            state["max"] = max(state["max"], state["now"])
        try:
            time.sleep(0.02)
            return apply(p, b)
        finally:
            with lock:
                state["now"] -= 1

    eng.apply = tracked                  # what the bucket callables call
    rids = [srv.submit(_cloud(40 + 7 * i, i)) for i in range(8)]
    srv.drain()
    for rid in rids:
        assert np.isfinite(srv.take(rid)).all()
    assert srv.report()["overlap"]["inflight_depth_max"] >= 2
    assert state["max"] == 1
    srv.close()


def test_fault_plan_parse_and_slow():
    plan = FaultPlan.parse("fail@1,nan@3,slow@5:80")
    assert plan.events[1].kind == "fail"
    assert plan.events[3].kind == "nan"
    assert plan.events[5] == serve.Fault("slow", 80.0)
    with pytest.raises(ValueError, match="bad fault item"):
        FaultPlan.parse("explode@1")
    with pytest.raises(ValueError, match="duplicate fault step"):
        FaultPlan.parse("fail@1,nan@1")
    stalls = []
    plan = FaultPlan.parse("slow@0:40", sleep=stalls.append)
    out = plan.wrap(lambda b: np.ones(3))(None)
    assert np.all(out == 1.0) and stalls == [0.04]


def test_synthetic_trace_shape():
    ev = synthetic_trace(n_requests=50, rate_hz=100, n_median=128,
                         sigma=0.4, n_min=32, n_max=256, seed=7)
    assert len(ev) == 50 and ev[0].t == 0.0
    assert all(e2.t >= e1.t for e1, e2 in zip(ev, ev[1:]))
    assert all(32 <= e.n_points <= 256 for e in ev)
    assert ev == synthetic_trace(n_requests=50, rate_hz=100, n_median=128,
                                 sigma=0.4, n_min=32, n_max=256, seed=7)
    # the same trace as the JAX package's, event for event
    jev = jserve.synthetic_trace(n_requests=50, rate_hz=100, n_median=128,
                                 sigma=0.4, n_min=32, n_max=256, seed=7)
    assert [(e.t, e.n_points) for e in ev] == [(e.t, e.n_points)
                                               for e in jev]


def test_make_cloud_matches_jax():
    from repro.data.synthetic import make_cloud as jmake_cloud
    for n, scene in ((100, False), (333, True)):
        np.testing.assert_array_equal(
            make_cloud(np.random.default_rng(5), n, scene),
            jmake_cloud(np.random.default_rng(5), n, scene))


# ---- keys -------------------------------------------------------------------

def test_key_data_takes_port_and_jax_keys():
    jkey = jax.random.fold_in(jax.random.PRNGKey(3), 11)
    want = np.asarray(jkey)
    tkey = random.fold_in(random.PRNGKey(3), 11)
    for k in (tkey, np.asarray(jkey), want.astype(np.int64)):
        got = key_data(k)
        assert got.dtype == np.uint32 and got.shape == (2,)
        np.testing.assert_array_equal(got, want)


# ---- the same request stream through the JAX server and the port's ---------

def test_server_matches_jax_server():
    """Same seed, same submissions, FakeClock, sync: the port's server
    makes the JAX server's dispatch decisions (rids, buckets, order,
    partial batches, padding waste, fault counters), gives each queued
    request the JAX server's default key (fold_in(PRNGKey(seed), rid)),
    and answers within 1e-4 of its logits.  The stream has a batch-full
    fire, a timeout-fired partial batch, a rejected NaN cloud and an
    injected failure answered by the fallback."""
    jspec = replace(jpointnet2.POINTNET2_C, blocks=tuple(
        jengine.BlockSpec(*b) for b in BLOCKS))
    jeng = jengine.PCNEngine(jspec, mode="lpcn", fc_backend="reference")
    jp = jeng.init(jax.random.PRNGKey(0))
    jp = jax.tree.map(lambda a: a + 0.05 if a.ndim == 1 else a, jp)
    tp = engine.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    teng = engine.PCNEngine(SPEC, mode="lpcn", fc_backend="cuda",
                            device="cpu")
    jclock, tclock = FakeClock(), FakeClock()
    kw = dict(timeout_s=0.1, sync=True, seed=4)
    jsrv = jserve.PCNServer(jeng, jp, jserve.BucketSet.make([64, 96], 2),
                            clock=jclock, faults=jserve.FaultPlan.parse(
                                "fail@1"), **kw)
    tsrv = PCNServer(teng, tp, BUCKETS, clock=tclock,
                     faults=FaultPlan.parse("fail@1"), **kw)
    nan_cloud = _cloud(50, 9)
    nan_cloud[7, 2] = np.nan
    # (cloud, seconds to advance after it, poll after it)
    stream = [(_cloud(60, 0), 0.05, True), (_cloud(90, 1), 0.05, True),
              (_cloud(33, 2), 0.0, False),          # 64 lane full: fires
              (nan_cloud, 0.0, False),              # rejected
              (_cloud(64, 3), 0.2, True),           # 96 lane times out
              (_cloud(72, 4), 0.0, False), (_cloud(17, 5), 0.0, False),
              (_cloud(96, 6), 0.0, False)]          # fires (fail@1)

    def queued_keys(srv):
        return {r.rid: np.asarray(r.key, np.uint32)
                for lane in srv.queue._lanes.values() for r in lane}

    rids = ([], [])
    for cloud, dt, poll in stream:
        for srv, clock, out in ((jsrv, jclock, rids[0]),
                                (tsrv, tclock, rids[1])):
            try:
                out.append(srv.submit(cloud))
            except ValidationError:
                out.append(None)
            except jserve.ValidationError:
                out.append(None)
            clock.advance(dt)
            if poll:
                srv.poll()
        jk, tk = queued_keys(jsrv), queued_keys(tsrv)
        assert jk.keys() == tk.keys()
        for rid in jk:
            np.testing.assert_array_equal(tk[rid], jk[rid])
    jsrv.drain()
    tsrv.drain()
    assert rids[0] == rids[1] and rids[0].count(None) == 1
    disp = [[(d.bucket, d.n_requests, d.valid_points, d.partial, d.degraded)
             for d in s.metrics.dispatches] for s in (jsrv, tsrv)]
    assert disp[0] == disp[1]
    reqs = [[(r.rid, r.bucket, r.n_points, r.t_arrival, r.t_dispatch)
             for r in s.metrics.requests] for s in (jsrv, tsrv)]
    assert reqs[0] == reqs[1]
    jrep, trep = jsrv.report(), tsrv.report()
    for k in ("requests", "dispatches", "full_batches", "partial_batches",
              "padding_waste_pct", "per_bucket", "faults", "buckets",
              "fault_plan", "breakers", "compile_count"):
        assert trep[k] == jrep[k], k
    assert trep["partial_batches"] >= 1
    assert trep["faults"]["rejected_invalid"] == 1
    assert trep["faults"]["degraded_dispatches"] == 1
    for rid in (r for r in rids[0] if r is not None):
        np.testing.assert_allclose(tsrv.take(rid), jsrv.take(rid),
                                   rtol=1e-4, atol=1e-4)


# ---- the kernel loader under threads ----------------------------------------

def test_loader_builds_once_under_threads(tmp_path, monkeypatch):
    """Threads that reach a cold kernel together run the compiler once
    and share one library (a stub compiler that sleeps, so an unguarded
    loader would run it once per thread)."""
    csrc, log = tmp_path / "csrc", tmp_path / "calls"
    csrc.mkdir()
    (csrc / "stub.cu").write_text("// stub\n")
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(
        f"#!{sys.executable}\n"
        "import sys, time\n"
        "time.sleep(0.3)\n"
        f"open({str(log)!r}, 'a').write('x')\n"
        "out = sys.argv[sys.argv.index('-o') + 1]\n"
        "open(out, 'w').write('lib')\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: ("lib", path))
    monkeypatch.setattr(_build, "_LIBS", {})
    barrier, libs = threading.Barrier(8), []

    def worker():
        barrier.wait(5.0)
        libs.append(_build.load("stub"))

    threads = [threading.Thread(target=worker) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30.0)
    assert not any(t.is_alive() for t in threads)
    assert log.read_text() == "x"                    # one compiler run
    assert len(libs) == 8 and len(set(libs)) == 1
    assert Path(libs[0][1]).exists()


def test_launch_counts_exact_under_threads():
    """Counts taken from more threads than cores, with a short switch
    interval, lose no launch."""
    from repro_torch import kernels
    n_threads, n_each = 16, 2000
    kernels.reset_launch_counts()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [
            _build.count_launch("gather_mlp", "hub_reuse")
            for _ in range(n_each)]) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60.0)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    counts = kernels.launch_counts()
    assert counts["gather_mlp"] == counts["hub_reuse"] == n_threads * n_each
    kernels.reset_launch_counts()
