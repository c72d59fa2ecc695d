"""Serving telemetry and SLO classes in the port against the JAX package, on
the CPU.

Mirrors ``tests/test_serving_observability.py`` (without its
``replica_group`` case) and the serving cases of ``tests/test_slo_metrics.py``
(the ring time series, SLO attainment, the scheduler's tagging and flows,
the disabled no-op). The port's telemetry (``deepspeed_tpu_torch.telemetry``)
is its own copy: ``SeriesRing``, the histogram buckets and quantiles and
the SLO attainment arithmetic must equal the JAX package's exactly on the
same values, and a scheduler run of the same tiny Llama (JAX weights
carried over by ``params_from_flax``, fp32) lands the same lifecycle
counts in both packages' summaries. Latency values are wall-clock and are
compared by their properties, not across packages.

With telemetry off, the scheduler reads no clock (its module-level ``_now``
is patched to raise), the KV cache's swap timers read none, and the
telemetry core allocates nothing.
"""

import json
import os
import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepspeed_tpu import telemetry as jax_telemetry
from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JaxEngine
from deepspeed_tpu.inference.v2.scheduler import SplitFuseScheduler as JaxScheduler
from deepspeed_tpu.inference.v2.scheduler import sheddable_classes as jax_sheddable
from deepspeed_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from deepspeed_tpu.models.llama import LlamaForCausalLM as JaxLlama
from deepspeed_tpu.telemetry import core as jax_core
from deepspeed_tpu.telemetry.timeseries import SeriesRing as JaxSeriesRing
from deepspeed_tpu_torch import telemetry
from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2, SplitFuseScheduler
from deepspeed_tpu_torch.inference.v2.scheduler import sheddable_classes
from deepspeed_tpu_torch.models.llama import (LlamaConfig, LlamaForCausalLM,
                                              params_from_flax)
from deepspeed_tpu_torch.telemetry import core as telemetry_core
from deepspeed_tpu_torch.telemetry.timeseries import SeriesRing

SLO_CLASSES = {
    "interactive": {"ttft_target_s": 0.5, "tpot_target_s": 0.25,
                    "attainment_target": 0.9},
    "batch": {"ttft_target_s": 60.0, "tpot_target_s": 30.0,
              "attainment_target": 0.9},
}
SCHEMA = os.path.join(os.path.dirname(telemetry_core.__file__),
                      "summary.schema.json")


def _off(tm):
    tm.reset()
    tm.configure(enabled=False, jsonl_path="", chrome_trace_path="",
                 sample_sync=True)


@pytest.fixture(autouse=True)
def _clean_telemetry():
    for tm in (telemetry, jax_telemetry):
        _off(tm)
    yield
    for tm in (telemetry, jax_telemetry):
        tm.close()
        _off(tm)


def both(**kw):
    """Configure the port's and the JAX package's pipelines alike."""
    telemetry.configure(**kw)
    jax_telemetry.configure(**kw)


@pytest.fixture(scope="module")
def served():
    jcfg = JaxLlamaConfig.tiny(scan_layers=True, remat=False, dtype=jnp.float32)
    jmodel = JaxLlama(jcfg)
    ids = np.random.default_rng(0).integers(0, jcfg.vocab_size,
                                            (1, 8)).astype(np.int32)
    params = jmodel.init(jax.random.PRNGKey(0), {"input_ids": ids})["params"]
    model = LlamaForCausalLM(LlamaConfig.tiny(dtype=torch.float32))
    model.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    return jmodel, params, model


def engine_config(num_kv_blocks=64, max_tokens=16, max_seqs=4, max_context=128,
                  host_kv_blocks=0, prefix_caching=False, spec=False,
                  slo_classes=None):
    config = {"state_manager": {"max_ragged_sequence_count": max_seqs,
                                "max_ragged_batch_size": max_tokens,
                                "max_context": max_context,
                                "num_kv_blocks": num_kv_blocks,
                                "host_kv_blocks": host_kv_blocks},
              "kv_cache": {"block_size": 8, "cache_dtype": "fp32"},
              "prefix_caching": prefix_caching}
    if spec:
        config["speculative"] = {"enabled": True, "max_draft_tokens": 4}
    if slo_classes is not None:
        config["slo_classes"] = slo_classes
    return config


def make_engine(served, jax_engine=False, **kw):
    jmodel, params, model = served
    if jax_engine:
        return JaxEngine(jmodel, params, config=engine_config(**kw))
    return InferenceEngineV2(model, engine_config(**kw), device="cpu")


def trace_events(tm):
    with open(tm.export_chrome_trace()) as f:
        return json.load(f)["traceEvents"]


def validate(summary):
    jsonschema = pytest.importorskip("jsonschema")
    with open(SCHEMA) as f:
        jsonschema.validate(summary, json.load(f))


def _template_prompt(seed, reps=10):
    rng = np.random.default_rng(seed)
    return np.tile(rng.integers(0, 512, 4), reps).astype(np.int32)


def _core_growth(snap0, snap1):
    flt = [__import__("tracemalloc").Filter(True, telemetry_core.__file__)]
    return [st for st in snap1.filter_traces(flt).compare_to(
        snap0.filter_traces(flt), "lineno") if st.size_diff > 0]


# ---------------------------------------------------------------------------
# histogram primitive
# ---------------------------------------------------------------------------

def test_hist_percentiles_ordered_clamped_and_equal_to_jax():
    both(enabled=True)
    vals = np.random.default_rng(0).lognormal(-3.0, 1.0, 4000)
    for v in vals:
        telemetry.record_hist("serving/ttft_s", float(v))
        jax_telemetry.record_hist("serving/ttft_s", float(v))
    p50, p95, p99 = telemetry.hist_percentiles("serving/ttft_s")
    assert (p50, p95, p99) == jax_telemetry.hist_percentiles("serving/ttft_s")
    assert p50 <= p95 <= p99
    assert vals.min() <= p50 <= vals.max()
    # log2 buckets: each estimate within one bucket (2x) of the true value
    true50, true99 = np.quantile(vals, [0.5, 0.99])
    assert true50 / 2 <= p50 <= true50 * 2
    assert true99 / 2 <= p99 <= true99 * 2
    assert telemetry.get_telemetry().hist_stats == \
        jax_telemetry.get_telemetry().hist_stats


def test_hist_helpers_equal_jax():
    rng = np.random.default_rng(1)
    vals = np.concatenate([[0.0, 1e-7, 1e-6, 2e-6, 1e4, 1e9],
                           rng.lognormal(-6, 4, 500)])
    for v in vals:
        assert telemetry_core._hist_bucket(v) == jax_core._hist_bucket(v)
    for i in range(telemetry_core.HIST_BUCKETS):
        assert telemetry_core._hist_bounds(i) == jax_core._hist_bounds(i)
    counts = [int(c) for c in rng.integers(0, 5, telemetry_core.HIST_BUCKETS)]
    h = {"counts": counts, "count": sum(counts), "min": 3e-6, "max": 7.0}
    for q in (0.0, 0.1, 0.5, 0.9, 0.95, 0.99, 1.0):
        assert telemetry_core._hist_quantile(h, q) == jax_core._hist_quantile(h, q)


def test_hist_single_value_exact():
    telemetry.configure(enabled=True)
    telemetry.record_hist("h", 0.005)
    assert telemetry.hist_percentiles("h") == (0.005, 0.005, 0.005)
    assert telemetry.hist_percentiles("missing") is None


def test_hist_in_summary_and_schema():
    telemetry.configure(enabled=True)
    for v in (0.001, 0.002, 0.01):
        telemetry.record_hist("serving/ttft_s", v)
    telemetry.serving_event("submitted")
    telemetry.serving_gauge("serving/running", 2)
    with telemetry.span("serving/forward"):
        pass
    telemetry.count("host_sync", what="x")
    s = telemetry.summary()
    h = s["serving"]["histograms"]["serving/ttft_s"]
    assert h["count"] == 3 and h["min_s"] == 0.001 and h["max_s"] == 0.01
    assert h["p50_s"] <= h["p95_s"] <= h["p99_s"]
    assert s["serving"]["requests"]["submitted"] == 1
    assert s["serving"]["gauges"]["serving/running"] == {"last": 2, "peak": 2}
    assert s["spans"]["serving/forward"]["count"] == 1
    assert s["counters"]["host_sync"] == {"what=x": 1}
    validate(s)
    assert telemetry.summary() != {"enabled": False}
    telemetry.configure(enabled=False)
    assert telemetry.summary() == {"enabled": False}


def test_unported_streams_raise_naming_their_queue_item():
    """The comm stream and the flight recorder wait for A15; the overlap
    report is ported: a malformed one raises the JAX package's
    ``ValueError`` (a valid one rides ``summary()["overlap"]``,
    ``tests/test_torch_overlap.py``)."""
    with pytest.raises(NotImplementedError, match="A15"):
        telemetry.record_comm("all_reduce", 1, 0.1)
    with pytest.raises(NotImplementedError, match="A15"):
        telemetry.flight_record("replica", "replica/lost", {})
    telemetry.configure(enabled=True)
    try:
        with pytest.raises(ValueError, match="invalid overlap report"):
            telemetry.attach_overlap({})
    finally:
        telemetry.configure(enabled=False)


# ---------------------------------------------------------------------------
# the serving stream end to end
# ---------------------------------------------------------------------------

def _serve(served, tm, jax_engine, uids=3, **eng_kw):
    engine = make_engine(served, jax_engine=jax_engine, **eng_kw)
    sched = (JaxScheduler if jax_engine else SplitFuseScheduler)(
        engine, token_budget=16)
    rng = np.random.default_rng(3)
    for uid in range(uids):
        sched.submit(uid, rng.integers(0, 512, 20).astype(np.int32),
                     max_new_tokens=4)
    return sched.run_to_completion(), tm.summary()


def test_serving_stream_end_to_end(served, tmp_path):
    """A CPU SplitFuse run: request lanes land in the Chrome trace,
    TTFT/TPOT percentiles are finite and ordered, the KV-occupancy gauge saw
    nonzero occupancy, and the lifecycle counts and histogram counts equal
    the JAX package's on the same workload."""
    both(enabled=True, sample_sync=False)
    telemetry.configure(chrome_trace_path=str(tmp_path / "trace.json"))
    out, s = _serve(served, telemetry, jax_engine=False)
    jout, js = _serve(served, jax_telemetry, jax_engine=True)
    assert {u: v.tolist() for u, v in out.items()} == \
        {u: v.tolist() for u, v in jout.items()}
    srv = s["serving"]
    assert srv["requests"] == js["serving"]["requests"] == \
        {"finished": 3, "submitted": 3}
    assert {k: h["count"] for k, h in srv["histograms"].items()} == \
        {k: h["count"] for k, h in js["serving"]["histograms"].items()}
    ttft, tpot = srv["histograms"]["serving/ttft_s"], srv["histograms"]["serving/tpot_s"]
    assert ttft["count"] == 3 and tpot["count"] == 3 * 3
    for h in (ttft, tpot, srv["histograms"]["serving/queue_wait_s"],
              srv["histograms"]["serving/e2e_s"]):
        assert np.isfinite([h["p50_s"], h["p99_s"]]).all()
        assert 0 < h["p50_s"] <= h["p99_s"]
    assert set(srv["gauges"]) == set(js["serving"]["gauges"])
    for name in ("serving/kv_occupancy", "serving/running",
                 "serving/token_budget_util", "serving/kv_free_blocks"):
        assert srv["gauges"][name] == js["serving"]["gauges"][name]
    assert srv["gauges"]["serving/kv_occupancy"]["peak"] > 0
    assert s["spans"]["serving/forward"]["count"] == \
        js["spans"]["serving/forward"]["count"]
    assert s["counters"]["host_sync"] == js["counters"]["host_sync"]
    validate(s)

    events = trace_events(telemetry)
    lanes = {e["args"]["name"] for e in events
             if e.get("ph") == "M" and e.get("name") == "thread_name"
             and e["args"]["name"].startswith("request/")}
    assert lanes == {"request/0", "request/1", "request/2"}
    phases = {e["name"] for e in events if e["name"].startswith("req/")}
    assert {"req/submit", "req/queued", "req/prefill", "req/decode",
            "req/finish"} <= phases
    assert all(e["tid"] >= 0x10000 for e in events if e["name"].startswith("req/"))


def test_preemption_and_resume_counters(served):
    """10 blocks of 8 tokens with two 44+6-token requests deadlock the pool;
    the host-swap preemption that breaks it shows in the serving counters,
    as in the JAX package."""
    both(enabled=True, sample_sync=False)
    counts = []
    for jax_engine, tm in ((False, telemetry), (True, jax_telemetry)):
        engine = make_engine(served, jax_engine=jax_engine, num_kv_blocks=10)
        sched = (JaxScheduler if jax_engine else SplitFuseScheduler)(
            engine, token_budget=16)
        rng = np.random.default_rng(7)
        for uid in range(2):
            sched.submit(uid, rng.integers(0, 512, 44).astype(np.int32),
                         max_new_tokens=6)
        out = sched.run_to_completion()
        assert all(len(out[u]) == 6 for u in range(2))
        counts.append(tm.summary()["serving"])
    srv, jsrv = counts
    assert srv["requests"] == jsrv["requests"]
    assert srv["requests"]["preempted"] >= 1 and srv["requests"]["resumed"] >= 1
    assert srv["gauges"]["serving/preempted"]["peak"] >= 1
    frag = srv["gauges"]["serving/kv_fragmentation"]
    assert 0.0 <= frag["peak"] <= 1.0


def test_kv_stats_pure_read(served):
    """``kv_stats`` never records; ``sample_kv_stats`` is the recording
    variant."""
    engine = make_engine(served)
    stats = engine._state.kv_stats()
    assert stats["total_blocks"] == 64 and stats["free_blocks"] == 64
    assert stats["occupancy"] == 0.0 and stats["fragmentation"] == 0.0
    telemetry.configure(enabled=True)
    engine.kv_stats()
    assert "serving/kv_occupancy" not in telemetry.summary()["serving"]["gauges"]
    assert engine.sample_kv_stats() == stats
    assert "serving/kv_occupancy" in telemetry.summary()["serving"]["gauges"]


def test_max_context_eviction_records_terminal_latency(served, tmp_path):
    """A request retired at max_context never finishes: the eviction is its
    terminal event, so it records ``serving/e2e_s`` and an evict lane."""
    telemetry.configure(enabled=True, sample_sync=False,
                        chrome_trace_path=str(tmp_path / "trace.json"))
    engine = make_engine(served, max_seqs=2, max_context=16, num_kv_blocks=8)
    sched = SplitFuseScheduler(engine)
    rng = np.random.default_rng(9)
    sched.submit(0, rng.integers(0, 512, 12).astype(np.int32),
                 max_new_tokens=10)  # 12 + 10 cannot fit 16: evicted at 4
    out = sched.run_to_completion()
    assert 1 <= len(out[0]) <= 4
    srv = telemetry.summary()["serving"]
    assert srv["requests"]["evicted"] == 1
    assert srv["requests"].get("finished", 0) == 0
    e2e = srv["histograms"]["serving/e2e_s"]
    assert e2e["count"] == 1 and np.isfinite(e2e["p50_s"])
    events = trace_events(telemetry)
    assert any(e["name"] == "req/evict" for e in events)


# ---------------------------------------------------------------------------
# disabled: no clock, no allocation
# ---------------------------------------------------------------------------

def _boom():
    raise AssertionError("the disabled telemetry path must not read the clock")


def _run_disabled(sched, submit_first, submit_rest):
    import tracemalloc
    submit_first()
    sched.step()  # warm the caches outside the traced window
    submit_rest()
    tracemalloc.start()
    snap0 = tracemalloc.take_snapshot()
    while sched.has_work:
        sched.step()
    snap1 = tracemalloc.take_snapshot()
    tracemalloc.stop()
    assert not _core_growth(snap0, snap1), "telemetry core allocated when disabled"


def test_disabled_serving_hooks_zero_overhead(served, monkeypatch):
    """Telemetry disabled, a scheduler run reads no clock, allocates nothing
    in the telemetry core and leaves its state untouched; with prefix
    caching off it also does no prefix-cache work."""
    from deepspeed_tpu_torch.inference.v2 import scheduler as sched_mod
    from deepspeed_tpu_torch.inference.v2.ragged import prefix_cache as pc_mod

    def _cache_boom(*a, **kw):
        raise AssertionError("prefix_caching off must mean no prefix-cache work")
    for name in ("__init__", "chain_digest", "lookup_chain", "acquire_chain",
                 "insert", "park_if_cached", "evict"):
        monkeypatch.setattr(pc_mod.PrefixCache, name, _cache_boom)
    engine = make_engine(served)
    assert engine._state.prefix_cache is None
    sched = SplitFuseScheduler(engine, token_budget=16)
    monkeypatch.setattr(sched_mod, "_now", _boom)
    rng = np.random.default_rng(5)
    _run_disabled(
        sched,
        lambda: sched.submit(0, rng.integers(0, 512, 12).astype(np.int32),
                             max_new_tokens=2),
        lambda: sched.submit(1, rng.integers(0, 512, 12).astype(np.int32),
                             max_new_tokens=3))
    tm = telemetry.get_telemetry()
    assert tm.hist_stats == {} and tm.serving_counters == {}
    assert tm.serving_gauges == {} and tm._request_lanes == {}
    assert telemetry.summary() == {"enabled": False}


def _spill_workload(sched, warm, rng):
    sched.submit(0, warm, max_new_tokens=2)
    sched.run_to_completion()   # parks warm's full blocks
    sched.submit(1, rng.integers(0, 512, 60).astype(np.int32), max_new_tokens=2)
    sched.run_to_completion()   # pressure: parked blocks spill to host
    sched.submit(2, np.concatenate([warm, rng.integers(0, 512, 6).astype(np.int32)]),
                 max_new_tokens=2)
    sched.run_to_completion()   # the shared prefix restores from the host


def test_disabled_swap_hooks_zero_clock_reads(served, monkeypatch):
    """The host tier's swap timers are free with telemetry off: a workload
    that spills and restores reads no clock in the KV cache."""
    from deepspeed_tpu_torch.inference.v2.ragged import kv_cache as kvc_mod
    monkeypatch.setattr(kvc_mod, "_now", _boom)
    engine = make_engine(served, num_kv_blocks=12, host_kv_blocks=16,
                         prefix_caching=True)
    rng = np.random.default_rng(21)
    _spill_workload(SplitFuseScheduler(engine, token_budget=16),
                    rng.integers(0, 512, 40).astype(np.int32), rng)
    assert engine.kv_stats()["kv_spilled"] >= 1
    assert engine.kv_stats()["kv_restored"] >= 1
    assert telemetry.summary() == {"enabled": False}


def test_swap_hists_recorded_when_enabled(served):
    """The same spill/restore workload with telemetry on lands
    ``serving/kv_swap_out_s`` and ``serving/kv_swap_in_s`` samples and the
    ``serving/host_kv_blocks`` gauge."""
    telemetry.configure(enabled=True, sample_sync=False)
    engine = make_engine(served, num_kv_blocks=12, host_kv_blocks=16,
                         prefix_caching=True)
    rng = np.random.default_rng(21)
    _spill_workload(SplitFuseScheduler(engine, token_budget=16),
                    rng.integers(0, 512, 40).astype(np.int32), rng)
    srv = telemetry.summary()["serving"]
    for name in ("serving/kv_swap_out_s", "serving/kv_swap_in_s"):
        assert srv["histograms"][name]["count"] >= 1
        assert np.isfinite(srv["histograms"][name]["p50_s"])
    assert srv["gauges"]["serving/host_kv_blocks"]["peak"] >= 1
    assert srv["requests"]["prefix_hit"] >= 1


# ---------------------------------------------------------------------------
# speculative decode hooks
# ---------------------------------------------------------------------------

def test_disabled_spec_hooks_zero_overhead(served, monkeypatch):
    """Telemetry disabled, a speculating run (drafts composed, verify chunks
    run, accept walks and rollbacks retired) reads no clock in the scheduler
    and allocates nothing in the telemetry core; the draft counters and the
    tokens-per-round EWMA stay live."""
    from deepspeed_tpu_torch.inference.v2 import scheduler as sched_mod
    sched = SplitFuseScheduler(make_engine(served, spec=True), token_budget=16)
    monkeypatch.setattr(sched_mod, "_now", _boom)
    _run_disabled(
        sched,
        lambda: sched.submit(0, _template_prompt(5), max_new_tokens=6),
        lambda: sched.submit(1, _template_prompt(5) + 1, max_new_tokens=8))
    assert sched.speculated_tokens > 0
    assert sched.tokens_per_round() >= 1.0
    assert telemetry.summary() == {"enabled": False}


def test_spec_stream_lands_gauges_events_and_phase(served, tmp_path):
    """A speculating run lands the ``speculated_tokens`` and
    ``rejected_tokens`` counters, the ``serving/accept_rate`` and
    ``serving/verify_batch_occupancy`` gauges and ``req/speculate`` lane
    phases; the summary validates, and its counts and gauges equal the JAX
    package's on the same workload."""
    both(enabled=True, sample_sync=False)
    telemetry.configure(chrome_trace_path=str(tmp_path / "trace.json"))
    runs = []
    for jax_engine, tm in ((False, telemetry), (True, jax_telemetry)):
        engine = make_engine(served, jax_engine=jax_engine, spec=True)
        sched = (JaxScheduler if jax_engine else SplitFuseScheduler)(
            engine, token_budget=16)
        sched.submit(0, _template_prompt(5), max_new_tokens=6)
        sched.submit(1, _template_prompt(5) + 1, max_new_tokens=8)
        out = sched.run_to_completion()
        runs.append(({u: v.tolist() for u, v in out.items()}, sched, tm.summary()))
    (out, sched, s), (jout, jsched, js) = runs
    assert out == jout
    assert len(out[0]) == 6 and len(out[1]) == 8
    assert sched.accepted_tokens > 0, "template workload must accept drafts"
    srv = s["serving"]
    assert srv["requests"] == js["serving"]["requests"]
    assert srv["requests"]["speculated_tokens"] == sched.speculated_tokens >= 1
    assert srv["requests"].get("rejected_tokens", 0) == sched.rejected_tokens
    for name in ("serving/accept_rate", "serving/verify_batch_occupancy"):
        assert srv["gauges"][name] == js["serving"]["gauges"][name]
    acc = srv["gauges"]["serving/accept_rate"]
    assert 0.0 <= acc["last"] <= 1.0 and 0.0 <= acc["peak"] <= 1.0
    assert 0.0 < srv["gauges"]["serving/verify_batch_occupancy"]["peak"] <= 1.0
    validate(s)
    spec_evts = [e for e in trace_events(telemetry) if e["name"] == "req/speculate"]
    assert spec_evts, "verify rounds land as a speculate lane phase"
    assert all(e["args"]["tokens"] >= 2 for e in spec_evts)
    assert all(e["tid"] >= 0x10000 for e in spec_evts)


# ---------------------------------------------------------------------------
# ring time series
# ---------------------------------------------------------------------------

def test_series_ring_matches_jax_on_random_streams():
    """Random streams (forward jumps past the ring, out-of-order stragglers,
    fractional windows) through the port's ring and the JAX package's: the
    same accept/drop verdict per record, the same live windows and the same
    lifetime totals, exactly."""
    for seed in range(6):
        rng = random.Random(seed)
        window_s = rng.choice([0.1, 0.5, 1.0, 2.5])
        num_windows = rng.choice([1, 3, 8, 32])
        ring = SeriesRing(window_s=window_s, num_windows=num_windows)
        ref = JaxSeriesRing(window_s=window_s, num_windows=num_windows)
        ts = 0.0
        for _ in range(800):
            r = rng.random()
            if r < 0.70:
                ts += rng.random() * window_s
            elif r < 0.90:
                ts += rng.random() * window_s * num_windows * 2
            else:
                ts = max(0.0, ts - rng.random() * window_s * num_windows)
            v = rng.uniform(-10, 10)
            assert ring.record(ts, v) == ref.record(ts, v)
        assert ring.windows() == ref.windows()
        assert ring.summary() == ref.summary()
        assert ring.rate_per_s(3) == ref.rate_per_s(3)
        assert ring.mean_over() == ref.mean_over()
        assert len(ring.windows()) <= num_windows


def test_series_ring_eviction_and_lifetime_totals():
    ring = SeriesRing(window_s=1.0, num_windows=4)
    for t in range(10):
        assert ring.record(t + 0.5, 1.0)
    assert [w["index"] for w in ring.windows()] == [6, 7, 8, 9]
    assert ring.total_count == 10 and ring.total_sum == 10.0
    assert not ring.record(2.0, 99.0)       # older than the tail: dropped
    assert ring.total_count == 10
    assert ring.record(6.1, 3.0)            # a straggler inside the ring
    assert ring.windows()[0] == {"index": 6, "start_s": 6.0, "count": 2,
                                 "sum": 4.0, "min": 1.0, "max": 3.0, "mean": 2.0}


def test_series_ring_rates_and_validation():
    ring = SeriesRing(window_s=0.5, num_windows=8)
    assert ring.windows() == [] and ring.rate_per_s() == 0.0
    assert ring.mean_over() == 0.0
    for i in range(4):
        ring.record(i * 0.5, 2.0)
        ring.record(i * 0.5 + 0.1, 4.0)
    assert ring.rate_per_s() == pytest.approx(4.0)
    assert ring.mean_over() == pytest.approx(3.0)
    assert ring.mean_over(last_n=1) == pytest.approx(3.0)
    s = ring.summary()
    assert s["total_count"] == 8 and len(s["windows"]) == 4
    with pytest.raises(ValueError):
        SeriesRing(window_s=0.0)
    with pytest.raises(ValueError):
        SeriesRing(num_windows=0)


def test_record_series_through_telemetry_summary():
    telemetry.configure(enabled=True)
    for i in range(5):
        telemetry.record_series("serving/queue_depth", float(i))
    wins = telemetry.series_windows("serving/queue_depth")
    assert wins and sum(w["count"] for w in wins) == 5
    assert telemetry.series_windows("nope") is None
    ring = telemetry.summary()["timeseries"]["serving/queue_depth"]
    assert ring["total_count"] == 5 and ring["total_sum"] == pytest.approx(10.0)
    assert ring["windows"] == wins
    assert ring["window_s"] > 0 and ring["num_windows"] >= 1


# ---------------------------------------------------------------------------
# SLO classes
# ---------------------------------------------------------------------------

def test_slo_attainment_arithmetic_and_gauges_equal_jax(tmp_path):
    both(enabled=True)
    telemetry.configure(jsonl_path=str(tmp_path / "t.jsonl"))
    for tm in (telemetry, jax_telemetry):
        tm.set_slo_classes(SLO_CLASSES)
        for _ in range(19):
            tm.slo_observe("interactive", "ttft", 0.1)    # within target
        tm.slo_observe("interactive", "ttft", 5.0)         # a violation
        tm.slo_observe("batch", "tpot", 1.0)
    snap = telemetry.slo_snapshot()
    assert snap == jax_telemetry.slo_snapshot()
    assert snap["interactive"]["metrics"]["ttft"] == {
        "requests": 20, "attained": 19, "violations": 1, "attainment": 0.95}
    assert snap["interactive"]["targets"]["ttft_target_s"] == 0.5
    assert snap["interactive"]["attainment_target"] == 0.9
    assert snap["batch"]["metrics"]["tpot"]["attainment"] == 1.0
    gauges = telemetry.summary()["serving"]["gauges"]
    jgauges = jax_telemetry.summary()["serving"]["gauges"]
    assert gauges == jgauges
    # budget 0.1; 1/20 violating -> burn rate 0.5, half the budget consumed
    assert gauges["slo/interactive/ttft_burn_rate"]["last"] == pytest.approx(0.5)
    assert gauges["slo/interactive/ttft_error_budget_remaining"]["last"] == \
        pytest.approx(0.5)
    assert gauges["slo/batch/tpot_burn_rate"]["last"] == 0.0
    assert telemetry.series_windows("slo/interactive/ttft_violations")
    assert sum(w["count"] for w in
               telemetry.series_windows("slo/interactive/ttft_requests")) == 20
    assert telemetry.gauge_value("slo/interactive/ttft_burn_rate") == \
        pytest.approx(0.5)
    telemetry.close()
    recs = [json.loads(l) for l in (tmp_path / "t.jsonl").read_text().splitlines()]
    slo_recs = [r for r in recs if r.get("kind") == "slo"]
    assert len(slo_recs) == 21  # one line per observation
    bad = [r for r in slo_recs if not r["tags"]["attained"]]
    assert len(bad) == 1 and bad[0]["name"] == "slo/interactive/ttft"
    assert bad[0]["tags"]["target_s"] == 0.5


def test_slo_unknown_class_histogram_only():
    telemetry.configure(enabled=True)
    telemetry.set_slo_classes(SLO_CLASSES)
    telemetry.slo_observe("mystery", "ttft", 0.2)
    s = telemetry.summary()
    assert s["slo"] == {}
    assert s["serving"]["histograms"]["serving/ttft_s/mystery"]["count"] == 1
    telemetry.set_slo_classes({"ttft_only": {"ttft_target_s": 1.0,
                                             "attainment_target": 0.9}})
    telemetry.slo_observe("ttft_only", "tpot", 0.2)
    assert "ttft_only" not in telemetry.slo_snapshot()


def test_scheduler_slo_tagging_and_flow_events(served, tmp_path):
    telemetry.configure(enabled=True, sample_sync=False,
                        chrome_trace_path=str(tmp_path / "trace.json"))
    sched = SplitFuseScheduler(make_engine(served, slo_classes=SLO_CLASSES),
                               token_budget=16)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, 512, 12).astype(np.int32) for _ in range(2)]
    sched.submit(0, prompts[0], max_new_tokens=3, slo_class="interactive")
    sched.submit(1, prompts[1], max_new_tokens=3, slo_class="batch")
    with pytest.raises(ValueError, match="unknown slo_class"):
        sched.submit(2, prompts[0], slo_class="platinum")
    out = sched.run_to_completion()
    assert all(len(out[u]) == 3 for u in (0, 1))
    snap = telemetry.slo_snapshot()
    assert set(snap) == {"interactive", "batch"}
    for cls in ("interactive", "batch"):
        for metric in ("ttft", "tpot"):
            st = snap[cls]["metrics"][metric]
            assert st["requests"] >= 1
            assert st["attained"] + st["violations"] == st["requests"]
    by_id = {}
    for e in trace_events(telemetry):
        if e.get("name") == "reqflow":
            by_id.setdefault(e["id"], []).append(e)
    assert set(by_id) == {0, 1}
    for chain in by_id.values():
        assert chain[0]["ph"] == "s" and chain[-1]["ph"] == "f"
        assert chain[-1]["bp"] == "e"
        assert {"submit", "prefill", "finish"} <= {e["args"]["point"] for e in chain}


def test_disabled_slo_hooks_zero_overhead(served, monkeypatch):
    """Telemetry disabled, a run with SLO classes configured and every
    request tagged reads no clock and allocates nothing in the telemetry
    core; record_series / slo_observe / record_request_flow stay no-ops."""
    import tracemalloc
    from deepspeed_tpu_torch.inference.v2 import scheduler as sched_mod
    sched = SplitFuseScheduler(make_engine(served, slo_classes=SLO_CLASSES),
                               token_budget=16)
    monkeypatch.setattr(sched_mod, "_now", _boom)
    rng = np.random.default_rng(5)
    sched.submit(0, rng.integers(0, 512, 12).astype(np.int32), max_new_tokens=2,
                 slo_class="interactive")
    sched.step()
    sched.submit(1, rng.integers(0, 512, 12).astype(np.int32), max_new_tokens=3,
                 slo_class="batch")
    tracemalloc.start()
    snap0 = tracemalloc.take_snapshot()
    while sched.has_work:
        sched.step()
    telemetry.record_series("x", 1.0)
    telemetry.slo_observe("interactive", "ttft", 0.1)
    telemetry.record_request_flow(7, "submit")
    snap1 = tracemalloc.take_snapshot()
    tracemalloc.stop()
    assert not _core_growth(snap0, snap1)
    tm = telemetry.get_telemetry()
    assert tm.series == {} and tm.slo_stats == {}
    assert telemetry.series_windows("x") is None
    assert telemetry.slo_snapshot() == {}
    assert telemetry.summary() == {"enabled": False}


@pytest.mark.parametrize("burning", [[], ["interactive"], ["batch"],
                                     ["interactive", "batch"], ["untargeted"]])
def test_sheddable_classes_equal_jax(burning):
    targets = dict(SLO_CLASSES, untargeted={"tpot_target_s": 1.0},
                   bulk={"ttft_target_s": 600.0})
    assert sheddable_classes(targets, burning) == jax_sheddable(targets, burning)


def test_burning_class_steers_preemption_as_in_jax(served):
    """While the interactive class burns (burn rate > 1), KV pressure
    preempts the batch-tagged row first, though the interactive row holds
    more blocks; the port counts the same SLO preemptions, swaps and tokens
    as the JAX scheduler on the same workload."""
    both(enabled=True, sample_sync=False)
    runs = []
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, 512, 44).astype(np.int32) for _ in range(2)]
    for jax_engine, tm in ((False, telemetry), (True, jax_telemetry)):
        engine = make_engine(served, jax_engine=jax_engine, num_kv_blocks=10,
                             slo_classes=SLO_CLASSES)
        sched = (JaxScheduler if jax_engine else SplitFuseScheduler)(
            engine, token_budget=16)
        for _ in range(4):
            tm.slo_observe("interactive", "ttft", 100.0)   # burn rate 10
        sched.submit(0, prompts[0], max_new_tokens=6, slo_class="interactive")
        sched.submit(1, prompts[1], max_new_tokens=6, slo_class="batch")
        out = sched.run_to_completion()
        runs.append(({u: v.tolist() for u, v in out.items()}, sched.slo_preemptions,
                     engine.swap_stats, tm.summary()["serving"]["requests"]))
    assert runs[0] == runs[1]
    assert runs[0][1] >= 1 and runs[0][3]["slo_preempted"] == runs[0][1]
