"""The port's serving fleet against the JAX package's, on the CPU.

Mirrors ``tests/test_fleet.py`` (SLO router + prefill/decode
disaggregation), the ``ReplicaGroup`` case of ``tests/test_inference_v2.py``,
``tests/test_serving_observability.py::test_replica_group_load_report`` and
the router / load-report cases of ``tests/test_speculative.py``. The same
tiny fp32 Llama (flax ``PRNGKey(0)`` weights through ``params_from_flax``)
serves in both packages, the port's replicas on ``devices=["cpu"] * 3``.

Against the JAX fleet: greedy streams are equal token for token, the
logits of a decode round after a handoff agree within 2e-5 (fp32 in both;
the forwards differ only in matmul and reduction order), the transports
ship and bind the same page counts, and the router gives the same typed
outcomes on the same submit sequence with telemetry off. Inside the port:
the fleet equals the monolithic engine bit for bit, greedy and seeded
(sampled tokens cannot match across the packages: their generators
differ), a handoff's pages bind bit for bit and the decode round after it
gives the monolithic engine's logits exactly.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax

from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JaxEngine
from deepspeed_tpu.inference.v2.fleet import PrefillDecodeFleet as JaxFleet
from deepspeed_tpu.inference.v2.fleet import SLORouter as JaxRouter
from deepspeed_tpu_torch import telemetry
from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2, ReplicaGroup,
                                              SplitFuseScheduler)
from deepspeed_tpu_torch.inference.v2.fleet import (PrefillDecodeFleet,
                                                    RequestAdmitted,
                                                    RequestQueued,
                                                    RequestRejected, SLORouter)
from deepspeed_tpu_torch.inference.v2.replica_group import model_on
from deepspeed_tpu_torch.telemetry import core as telemetry_core
from torch_fleet_support import (DEVICES, ENG, assert_bit_exact, clean_state,
                                 jax_single_reference, requests, served_models,
                                 single_reference)

ATOL = 2e-5


@pytest.fixture(autouse=True)
def _clean():
    clean_state()
    yield
    clean_state()


@pytest.fixture(scope="module")
def served():
    return served_models()


def make_fleet(model, **kw):
    kw.setdefault("engine_config", ENG)
    kw.setdefault("token_budget", 48)
    return PrefillDecodeFleet(model, prefill_replicas=2, decode_replicas=1,
                              devices=DEVICES, **kw)


def make_jax_fleet(jmodel, params, **kw):
    kw.setdefault("engine_config", ENG)
    kw.setdefault("token_budget", 48)
    return JaxFleet(jmodel, params, prefill_replicas=2, decode_replicas=1, **kw)


def _shed_prompts(vocab):
    rng = np.random.default_rng(2)
    return [rng.integers(0, vocab, 24).astype(np.int32) for _ in range(5)]


def _outcome(o):
    """A router outcome as comparable plain values."""
    if isinstance(o, RequestAdmitted) or type(o).__name__ == "RequestAdmitted":
        return ("admitted", o.uid, o.replica, o.predicted_ttft_s, o.affinity_tokens)
    if type(o).__name__ == "RequestQueued":
        return ("queued", o.uid, o.position, o.predicted_ttft_s)
    return ("rejected", o.uid, o.reason, o.predicted_ttft_s)


@pytest.fixture(scope="module")
def jax_ref(served):
    """The JAX fleet's runs the module compares with, each made once."""
    jcfg, jmodel, params, _ = served
    clean_state()
    out = {}
    reqs = requests(jcfg.vocab_size, n=4, seed=5)
    fleet = make_jax_fleet(jmodel, params)
    for uid, (prompt, kwargs) in reqs.items():
        fleet.submit(uid, prompt, **kwargs)
    out["greedy"] = {u: np.asarray(v, np.int32)
                     for u, v in fleet.run_to_completion().items()}
    out["greedy_transport"] = fleet.transport.stats()
    fleet = make_jax_fleet(jmodel, params)
    router = JaxRouter(fleet, slo_ttft_s=1e-9, queue_limit=2, prefix_affinity=False)
    out["shed_outcomes"] = [_outcome(router.submit(uid, p, max_new_tokens=3))
                            for uid, p in enumerate(_shed_prompts(jcfg.vocab_size))]
    out["shed_results"] = {u: np.asarray(v, np.int32)
                           for u, v in router.run_to_completion().items()}
    out["shed_report"] = router.report()
    fleet = make_jax_fleet(jmodel, params)
    router = JaxRouter(fleet, slo_ttft_s=60.0, prefix_affinity=False)
    out["admit_outcomes"] = [
        _outcome(router.submit(0, np.arange(16, dtype=np.int32) % jcfg.vocab_size,
                               max_new_tokens=2)),
        _outcome(router.submit(1, np.zeros(200, np.int32), max_new_tokens=2))]
    out["handoff_logits"] = _jax_handoff_logits(jmodel, params)
    return out


def _handoff_prompt():
    return np.random.default_rng(3).integers(0, 512, 29).astype(np.int32)


def _jax_handoff_logits(jmodel, params):
    """Prefill on one JAX engine, ship its pages to a second, and run the
    first decode round there: (prefill logits, decode logits)."""
    src = JaxEngine(jmodel, params, config=ENG)
    dst = JaxEngine(jmodel, params, config=ENG)
    prompt = _handoff_prompt()
    first = src.put([0], [prompt])
    h = src.export_pages(0)
    dst.import_pages(0, h)
    tok = int(np.argmax(first[0]))
    return first, dst.put([0], [np.asarray([tok], np.int32)])


# ---------------------------------------------------------------------------
# bit-exact disaggregation
# ---------------------------------------------------------------------------

def test_fleet_greedy_bit_exact_vs_single(served, jax_ref):
    """Greedy fleet output (prefill -> ship -> decode) equals the port's
    monolithic run and the JAX fleet's token for token, with the JAX
    transport's page counts."""
    jcfg, _, _, model = served
    reqs = requests(jcfg.vocab_size, n=4, seed=5)
    want = single_reference(model, reqs)
    fleet = make_fleet(model)
    for uid, (prompt, kwargs) in reqs.items():
        fleet.submit(uid, prompt, **kwargs)
    got = fleet.run_to_completion()
    assert set(got) == set(want)
    assert_bit_exact(got, want)
    assert_bit_exact(got, jax_ref["greedy"])
    st, jst = fleet.transport.stats(), jax_ref["greedy_transport"]
    assert fleet.transport.handoffs == len(reqs) == jst["handoffs"]
    assert st["pages_shipped"] == st["pages_bound"] == jst["pages_shipped"] \
        == jst["pages_bound"] > 0
    assert 0 < fleet.transport.transfers <= fleet.transport.handoffs


def test_fleet_seeded_sampling_bit_exact_vs_single(served):
    """Seeded sampling is deterministic per (seed, position): the decode
    side inherits the stream mid-request and the fleet equals the port's
    monolithic run exactly."""
    jcfg, _, _, model = served
    reqs = requests(jcfg.vocab_size, n=4, seed=11, sampling=True)
    want = single_reference(model, reqs)
    fleet = make_fleet(model)
    for uid, (prompt, kwargs) in reqs.items():
        fleet.submit(uid, prompt, **kwargs)
    assert_bit_exact(fleet.run_to_completion(), want)


def test_single_token_request_finishes_at_prefill(served):
    jcfg, _, _, model = served
    fleet = make_fleet(model)
    prompt = np.arange(20, dtype=np.int32) % jcfg.vocab_size
    fleet.submit(0, prompt, max_new_tokens=1)
    out = fleet.run_to_completion()
    assert len(out[0]) == 1
    assert fleet.transport.handoffs == 0
    assert fleet.transport.transfers == 0


def test_handoff_binds_pages_and_logits_bit_exact(served, jax_ref):
    """One request's pages cross between two engines: the pages bound at
    the destination equal the exported ones bit for bit, the decode round
    there gives the logits the source engine gives for the same round
    (exactly), and both agree with the JAX package's handoff within 2e-5."""
    _, _, _, model = served
    prompt = _handoff_prompt()
    src = InferenceEngineV2(model, ENG, device="cpu")
    dst = InferenceEngineV2(model, ENG, device="cpu")
    mono = InferenceEngineV2(model, ENG, device="cpu")
    first = src.put([0], [prompt])
    np.testing.assert_array_equal(first, mono.put([0], [prompt]))
    h = src.export_pages(0)
    assert src._state.get_sequence(0) is None  # the export released it
    k, v = h["k"].clone(), h["v"].clone()
    dst.import_pages(0, h)
    blocks = torch.tensor(dst._state.get_sequence(0).kv_blocks)
    kv = dst._state.kv_cache
    assert torch.equal(kv.k_pool[:, blocks], k) and torch.equal(kv.v_pool[:, blocks], v)
    tok = np.asarray([int(np.argmax(first[0]))], np.int32)
    got = dst.put([0], [tok])
    np.testing.assert_array_equal(got, mono.put([0], [tok]))
    jfirst, jgot = jax_ref["handoff_logits"]
    np.testing.assert_allclose(first, jfirst, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, jgot, atol=ATOL, rtol=0)


def test_export_gathers_a_copy_and_int8_ships_pairs(served):
    """The export copies: freeing and rewriting the source blocks leaves the
    shipped pages intact. int8 pools ship (data, scale) pairs, and rows past
    ``n`` bind into the trash block."""
    _, _, _, model = served
    eng = dict(ENG, state_manager=dict(ENG["state_manager"], kv_dtype="int8"))
    src = InferenceEngineV2(model, eng, device="cpu")
    dst = InferenceEngineV2(model, eng, device="cpu")
    src.put([0], [_handoff_prompt()])
    blocks = list(src._state.get_sequence(0).kv_blocks)
    h = src.export_pages(0)
    (kd, ks), (vd, vs) = h["k"], h["v"]
    assert kd.dtype == torch.int8 and ks.dtype == torch.float32
    saved = [t.clone() for t in (kd, ks, vd, vs)]
    kc = src._state.kv_cache
    kc.k_pool[:, blocks] = 0
    kc.k_scale[:, blocks] = 0
    assert all(torch.equal(a, b) for a, b in zip(saved, (kd, ks, vd, vs)))
    n = h["n"]
    pad = lambda t: torch.cat([t, t[:, :1]], 1)  # one padding row
    ids = dst._state.kv_cache.import_blocks((pad(kd), pad(ks)), (pad(vd), pad(vs)), n)
    assert len(ids) == n and dst.free_blocks == 96 - n
    dk = dst._state.kv_cache
    assert torch.equal(dk.k_pool[:, ids], saved[0])
    assert torch.equal(dk.k_scale[:, ids], saved[1])
    with pytest.raises(ValueError, match="dtype mismatch"):
        InferenceEngineV2(model, ENG, device="cpu")._state.kv_cache.import_blocks(
            (kd, ks), (vd, vs), n)


# ---------------------------------------------------------------------------
# router admission under saturation
# ---------------------------------------------------------------------------

def test_router_typed_outcomes_and_shedding(served, jax_ref):
    """Past-SLO requests queue up to the bound, then shed: the typed
    outcomes (and their predicted TTFTs) equal the JAX router's on the same
    submit sequence, and the queued requests still run to completion."""
    jcfg, _, _, model = served
    router = SLORouter(make_fleet(model), slo_ttft_s=1e-9, queue_limit=2,
                       prefix_affinity=False)
    outcomes = [router.submit(uid, p, max_new_tokens=3)
                for uid, p in enumerate(_shed_prompts(jcfg.vocab_size))]
    assert [type(o) for o in outcomes] == [RequestQueued, RequestQueued,
                                           RequestRejected, RequestRejected,
                                           RequestRejected]
    assert outcomes[2].reason.startswith("predicted TTFT")
    assert [_outcome(o) for o in outcomes] == jax_ref["shed_outcomes"]
    assert router.report()["queue_depth"] == 2
    assert router.shed_rate == pytest.approx(3 / 5)
    out = router.run_to_completion()
    assert set(out) == {0, 1}
    assert all(len(v) == 3 for v in out.values())
    assert_bit_exact(out, jax_ref["shed_results"])
    rep, jrep = router.report(), jax_ref["shed_report"]
    assert rep["admitted"] + rep["rejected"] == rep["submitted"]
    assert rep["queue_depth"] == 0
    for key in ("submitted", "admitted", "queued", "rejected", "accounting"):
        assert rep[key] == jrep[key], key


def test_router_admits_under_slo_and_rejects_unservable(served, jax_ref):
    jcfg, _, _, model = served
    router = SLORouter(make_fleet(model), slo_ttft_s=60.0, prefix_affinity=False)
    a = router.submit(0, np.arange(16, dtype=np.int32) % jcfg.vocab_size,
                      max_new_tokens=2)
    assert isinstance(a, RequestAdmitted)
    assert 0 < a.predicted_ttft_s <= 60.0
    r = router.submit(1, np.zeros(200, np.int32), max_new_tokens=2)
    assert isinstance(r, RequestRejected) and "max_context" in r.reason
    assert [_outcome(a), _outcome(r)] == jax_ref["admit_outcomes"]
    assert len(router.run_to_completion()[0]) == 2


def test_router_prefix_affinity_pulls_to_warm_replica(served):
    jcfg, _, _, model = served
    fleet = make_fleet(model, engine_config=dict(ENG, prefix_caching=True))
    prompt = np.random.default_rng(9).integers(0, jcfg.vocab_size, 33).astype(np.int32)
    # seed replica 1's prefix cache: the export at handoff commits the
    # prefilled blocks before releasing them
    fleet.submit(0, prompt, max_new_tokens=3, replica=1)
    fleet.run_to_completion()
    assert fleet.prefill[1][1].peek_prefix(prompt) > 0
    router = SLORouter(fleet, slo_ttft_s=60.0)
    a = router.submit(1, prompt, max_new_tokens=3)
    assert isinstance(a, RequestAdmitted)
    assert a.replica == 1 and a.affinity_tokens > 0
    assert router.affinity_hits == 1
    router.run_to_completion()


# ---------------------------------------------------------------------------
# page conservation + cancellation
# ---------------------------------------------------------------------------

def _total_free(fleet):
    return {role: [s.engine.free_blocks for _, s in side]
            for role, side in (("prefill", fleet.prefill), ("decode", fleet.decode))}


def test_fleet_drains_all_kv_pages(served):
    jcfg, _, _, model = served
    fleet = make_fleet(model)
    before = _total_free(fleet)
    for uid, (prompt, kwargs) in requests(jcfg.vocab_size, n=4, seed=13).items():
        fleet.submit(uid, prompt, **kwargs)
    fleet.run_to_completion()
    assert _total_free(fleet) == before
    assert fleet.page_census()["leaked_pages"] == 0


def test_warm_transport_holds_no_ids(served):
    """``warm_transport`` runs every prefill -> decode page path once on
    trash-block rows: no block id stays held and the transport's counters
    stay at zero."""
    _, _, _, model = served
    fleet = make_fleet(model)
    before = _total_free(fleet)
    fleet.warm_transport(max_pages=5)
    fleet.warm_transport()
    assert _total_free(fleet) == before
    assert fleet.transport.stats()["pages_shipped"] == 0


def test_fleet_cancel_frees_pages_on_either_side(served):
    jcfg, _, _, model = served
    reqs = requests(jcfg.vocab_size, n=3, seed=17, max_new=8)
    want = single_reference(model, {2: reqs[2]})
    fleet = make_fleet(model)
    before = _total_free(fleet)
    for uid, (prompt, kwargs) in reqs.items():
        fleet.submit(uid, prompt, **kwargs)
    assert fleet.cancel(0)          # still queued / prefilling
    while fleet.transport.handoffs == 0 and fleet.has_work:
        fleet.step()
    handed = [uid for uid, r in fleet._route.items() if r[0] == "decode"]
    if 1 in handed:
        assert fleet.cancel(1)      # now lives on the decode side
    out = fleet.run_to_completion()
    np.testing.assert_array_equal(np.asarray(out[2], np.int32), want[2])
    assert _total_free(fleet) == before
    assert fleet.cancel(99) is False


# ---------------------------------------------------------------------------
# load signals + telemetry
# ---------------------------------------------------------------------------

def test_load_report_and_public_accessors(served):
    jcfg, _, _, model = served
    fleet = make_fleet(model)
    rep = fleet.load_report()
    assert [r["replica"] for r in rep["replicas"]] == ["prefill0", "prefill1", "decode0"]
    assert all(r["active"] == 0 and r["kv_occupancy"] == 0.0 for r in rep["replicas"])
    assert all(r["device"] == "cpu" for r in rep["replicas"])
    assert rep["transport"]["pages_shipped"] == 0
    replica = fleet.submit(0, np.arange(30, dtype=np.int32) % jcfg.vocab_size,
                           max_new_tokens=4)
    sched = fleet.prefill[replica][1]
    assert sched.active_count() == 1
    assert {"occupancy", "free_blocks"} <= set(sched.kv_stats())
    fleet.run_to_completion()
    assert sched.active_count() == 0


def test_fleet_telemetry_stream(served):
    """Router admissions and handoffs land in summary()["fleet"], which the
    schema describes."""
    jcfg, _, _, model = served
    telemetry.configure(enabled=True, sample_sync=False)
    router = SLORouter(make_fleet(model), slo_ttft_s=60.0, prefix_affinity=False)
    for uid, (prompt, kwargs) in requests(jcfg.vocab_size, n=3, seed=23).items():
        assert isinstance(router.submit(uid, prompt, **kwargs), RequestAdmitted)
    router.run_to_completion()
    s = telemetry.summary()
    flt = s["fleet"]
    assert flt["events"]["admitted"] == 3
    h = flt["handoff"]
    assert h["count"] == 3
    assert h["pages_shipped"] == h["pages_bound"] > 0
    assert h["bytes"] > 0 and h["total_s"] > 0
    hists = s["serving"]["histograms"]
    assert hists["fleet/predicted_ttft_s"]["count"] == 3
    assert hists["fleet/handoff_s"]["count"] == 3
    jsonschema = pytest.importorskip("jsonschema")
    with open(os.path.join(os.path.dirname(telemetry_core.__file__),
                           "summary.schema.json")) as f:
        jsonschema.validate(s, json.load(f))


def test_disagg_load_report_carries_tokens_per_round(served):
    _, _, _, model = served
    fleet = make_fleet(model, speculative_default=False)
    rep = fleet.load_report()
    assert all(r["tokens_per_round"] == 1.0 for r in rep["replicas"])


class _StubSched:
    """Router-target stand-in exposing exactly the load-signal surface."""

    def __init__(self, tokens_per_round=None):
        self.budget = 4
        self.max_context = 128
        if tokens_per_round is not None:
            self.tokens_per_round = lambda: tokens_per_round

    def kv_stats(self):
        return {"occupancy": 0.2}

    def peek_prefix(self, prompt):
        return 0

    def active_count(self):
        return 0


class _StubBackend:
    def __init__(self, targets):
        self._targets = targets
        self.placed = []

    def router_targets(self):
        return [(None, t) for t in self._targets]

    def submit(self, uid, prompt, replica=None, **kw):
        self.placed.append((uid, replica))

    def step(self):
        return []

    @property
    def has_work(self):
        return False

    def results(self):
        return {}


def test_router_prefers_speculating_backend_at_equal_occupancy():
    plain, spec = _StubSched(), _StubSched(tokens_per_round=3.0)
    backend = _StubBackend([plain, spec])
    router = SLORouter(backend, slo_ttft_s=60.0, prefix_affinity=False)
    # 16 owed tokens over budget 4: plain needs 4 rounds, spec ceil(16/12)=2
    assert router.predicted_ttft(0, 16) > router.predicted_ttft(1, 16)
    out = router.submit(0, np.arange(16, dtype=np.int32), max_new_tokens=1)
    assert isinstance(out, RequestAdmitted) and out.replica == 1
    assert backend.placed == [(0, 1)]
    slow = _StubSched(tokens_per_round=0.25)
    router2 = SLORouter(_StubBackend([plain, slow]), slo_ttft_s=60.0,
                        prefix_affinity=False)
    assert router2.predicted_ttft(0, 16) == router2.predicted_ttft(1, 16)


# ---------------------------------------------------------------------------
# ReplicaGroup
# ---------------------------------------------------------------------------

GROUP_ENG = {"state_manager": {"max_ragged_sequence_count": 4,
                               "max_ragged_batch_size": 16,
                               "max_context": 128, "num_kv_blocks": 64},
             "kv_cache": {"block_size": 8, "cache_dtype": "fp32"}}


def test_replica_group_matches_single_engine(served):
    """Two replicas on one device share the model's weight tensors and give
    the greedy tokens of one engine, and of the JAX package's engine."""
    jcfg, jmodel, params, model = served
    rng = np.random.default_rng(0)
    rng.integers(0, jcfg.vocab_size, (1, 8))
    prompts = {u: rng.integers(0, jcfg.vocab_size, 9 + 3 * u).astype(np.int32)
               for u in range(4)}
    group = ReplicaGroup(model, ["cpu", "cpu"], engine_config=GROUP_ENG, token_budget=16)
    assert group.replica_num == 2
    assert all(s.engine._model is model for _, s in group.replicas)
    placed = {group.submit(u, p, max_new_tokens=4) for u, p in prompts.items()}
    assert placed == {0, 1}
    got = group.run_to_completion()
    single = SplitFuseScheduler(InferenceEngineV2(model, GROUP_ENG, device="cpu"),
                                token_budget=16)
    for u, p in prompts.items():
        single.submit(u, p, max_new_tokens=4)
    want = single.run_to_completion()
    jwant = jax_single_reference(jmodel, params,
                                 {u: (p, {"max_new_tokens": 4}) for u, p in prompts.items()},
                                 eng=GROUP_ENG, budget=16)
    for u in prompts:
        assert got[u].tolist() == want[u].tolist() == jwant[u].tolist(), u


def test_replica_group_load_report(served):
    jcfg, _, _, model = served
    telemetry.configure(enabled=True, sample_sync=False)
    group = ReplicaGroup(model, ["cpu", "cpu"], engine_config=GROUP_ENG, token_budget=16)
    rng = np.random.default_rng(11)
    for uid in range(4):
        group.submit(uid, rng.integers(0, jcfg.vocab_size, 10).astype(np.int32),
                     max_new_tokens=2)
    rep = group.load_report()
    assert [p["assigned"] for p in rep["replicas"]] == [2, 2]
    assert rep["active_skew"] == 0.0
    assert "serving/replica_skew" in telemetry.summary()["serving"]["gauges"]
    assert group.cancel(3) and not group.cancel(3)
    out = group.run_to_completion()
    assert len(out) == 4 and len(out[3]) < 2


def test_replicas_at_tp_above_one_raise_naming_their_queue_item(served):
    _, _, _, model = served
    with pytest.raises(NotImplementedError, match="A5 part 3"):
        ReplicaGroup(model, ["cpu"], tp_size=2)
    with pytest.raises(NotImplementedError, match="A5 part 3"):
        make_fleet(model, tp_size=2)
    assert model_on(model, "cpu") is model


def test_step_begin_finish_is_step_with_one_fetch(served):
    """``step()`` is ``step_finish(step_begin())``: the same tokens, and the
    round's one accounted host fetch happens in ``step_finish``."""
    jcfg, _, _, model = served
    reqs = requests(jcfg.vocab_size, n=3, seed=19)
    want = single_reference(model, reqs)
    engine = InferenceEngineV2(model, ENG, device="cpu")
    sched = SplitFuseScheduler(engine, token_budget=48)
    for uid, (prompt, kwargs) in reqs.items():
        sched.submit(uid, prompt, **kwargs)
    while sched.has_work:
        before = engine.host_sync_count
        pending = sched.step_begin()
        assert engine.host_sync_count == before  # no sync before the finish
        if pending is not None:
            sched.step_finish(pending)
            assert engine.host_sync_count == before + 1
    assert_bit_exact(sched.results(), want)
