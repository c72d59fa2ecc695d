"""The port's KV fabric against the JAX package's, on the CPU.

Mirrors ``tests/test_kv_fabric.py`` without its four NVMe cases (the NVMe
rung waits for ROADMAP A14). Wire-format units first (frame round trip, CRC
localization, version skew, the int8-vs-fp32 byte ratio), then the frames
across the packages: the same pages encode to the same bytes in both (int8
pools, raw fp32 and raw bf16 pages, and the wire-quantized fp32 leg), a
JAX-encoded frame decodes in the port and the reverse, and a JAX engine's
shipped pages serve the port's decode round within 2e-5 of the JAX
engine's. Then flow control, and the fleet over the serialized codec
(int8 pools: lossless, so greedy streams equal the monolithic run and the
JAX package's): delta shipping, injected corruption driving the
retry-then-fallback ladder, the speculative default on the decode side,
the true wire bytes in telemetry, and the two-process fabric (the decode
side in a spawned process) against the in-process fleet under the same
codec.
"""

import numpy as np
import pytest
import torch

import jax
import ml_dtypes

from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JaxEngine
from deepspeed_tpu.inference.v2.fleet import wire as jax_wire
from deepspeed_tpu_torch import telemetry
from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2
from deepspeed_tpu_torch.inference.v2.fleet import (FlowControl,
                                                    PrefillDecodeFleet, SLORouter)
from deepspeed_tpu_torch.inference.v2.fleet import wire
from deepspeed_tpu_torch.inference.v2.fleet.two_process import (TwoProcessFleet,
                                                                _recv, _send)
from deepspeed_tpu_torch.inference.v2.fleet.wire import (WireCRCError,
                                                         WireVersionError)
from deepspeed_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from deepspeed_tpu_torch.resilience import faults
from torch_fleet_support import (WIRE_ENG, assert_bit_exact, clean_state,
                                 jax_single_reference, prefix_requests,
                                 served_models, single_reference)

ATOL = 2e-5


@pytest.fixture(autouse=True)
def _clean():
    clean_state()
    yield
    clean_state()


# ---------------------------------------------------------------------------
# wire format units
# ---------------------------------------------------------------------------

def _int8_arrays(n=3, rows=4, L=2, H=2, bs=8, hd=32, seed=0):
    """Synthetic int8 pool rows + fp32 per-token scales (numpy)."""
    rng = np.random.default_rng(seed)
    kd = rng.integers(-128, 128, (L, rows, H, bs, hd)).astype(np.int8)
    vd = rng.integers(-128, 128, (L, rows, H, bs, hd)).astype(np.int8)
    ks = rng.random((L, rows, H, 1, bs)).astype(np.float32)
    vs = rng.random((L, rows, H, 1, bs)).astype(np.float32)
    seqs = [{"uid": 7, "n": n, "seen_tokens": n * bs,
             "tokens": list(range(n * bs))}]
    return (kd, ks), (vd, vs), seqs


def _handle(k, v, seqs, n, as_torch=True):
    conv = (lambda a: torch.from_numpy(a)) if as_torch else (lambda a: a)
    pages = lambda p: tuple(conv(a) for a in p) if isinstance(p, tuple) else conv(p)
    return {"n": n, "k": pages(k), "v": pages(v), "seqs": seqs}


def _int8_handle(n=3, rows=3, **kw):
    k, v, seqs = _int8_arrays(n=n, rows=rows, **kw)
    return _handle(k, v, seqs, n)


def test_wire_roundtrip_int8_lossless():
    """int8 pages + scales ship byte for byte: decode returns exactly the n
    pool rows, on the device asked for."""
    h = _int8_handle(n=3, rows=3)
    frame = wire.encode_handle(h)
    out = wire.decode_frame(frame, "cpu")
    assert out["n"] == 3 and out["wire_nbytes"] == len(frame)
    for src, dst in ((h["k"], out["k"]), (h["v"], out["v"])):
        for a, b in zip(src, dst):
            assert b.shape == a.shape and torch.equal(a, b)
    assert out["seqs"][0]["uid"] == 7
    assert out["seqs"][0]["tokens"] == list(range(24))


def test_wire_roundtrip_delta_digests():
    h = _int8_handle(n=2, rows=2)
    h["seqs"] = [{"uid": 1, "n": 2, "seen_tokens": 40, "tokens": [1, 2],
                  "skipped": 3, "skipped_digests": [b"\x01" * 32, b"\x02" * 32,
                                                    b"\xff" * 32]}]
    m = wire.decode_frame(wire.encode_handle(h), "cpu")["seqs"][0]
    assert m["skipped"] == 3
    assert m["skipped_digests"] == [b"\x01" * 32, b"\x02" * 32, b"\xff" * 32]


def test_wire_int8_page_under_fp32_ratio():
    """An int8 wire page (hd data + 4 scale bytes per token row) costs
    36/128 of the fp32 bytes it replaces at head width 32."""
    h = _int8_handle(n=4, rows=4, hd=32)
    pw = wire.page_wire_nbytes(h["k"], h["v"])
    pf = wire.page_fp32_nbytes(h["k"], h["v"])
    assert pw / pf == pytest.approx(0.28125)
    empty = _int8_handle(n=0, rows=0)
    assert wire.page_wire_nbytes(empty["k"], empty["v"]) == pw


def test_wire_fp_pool_quantizes_at_wire():
    rng = np.random.default_rng(3)
    n, L, H, bs, hd = 2, 2, 2, 4, 32
    k = rng.standard_normal((L, n, H, bs, hd)).astype(np.float32)
    v = rng.standard_normal((L, n, H, bs, hd)).astype(np.float32)
    h = _handle(k, v, [{"uid": 0, "n": n, "seen_tokens": 8, "tokens": []}], n)
    frame = wire.encode_handle(h, wire_quantize=True)
    raw = wire.encode_handle(h, wire_quantize=False)
    assert len(frame) < 0.5 * len(raw)
    out = wire.decode_frame(frame, "cpu")
    assert out["k"].dtype == torch.float32
    np.testing.assert_allclose(out["k"].numpy(), k, atol=2e-2)
    np.testing.assert_allclose(out["v"].numpy(), v, atol=2e-2)


def test_wire_crc_flip_detected_and_localized():
    frame = wire.encode_handle(_int8_handle(n=3))
    with pytest.raises(WireCRCError) as ei:
        wire.decode_frame(wire.corrupt(frame), "cpu")
    assert ei.value.page == 2 and "page 2" in str(ei.value)


def test_wire_version_skew_rejected():
    frame = wire.encode_handle(_int8_handle(n=1, rows=1))
    with pytest.raises(WireVersionError, match="bad magic"):
        wire.decode_frame(b"XKVX" + frame[4:], "cpu")
    skew = bytearray(frame)
    skew[4] ^= 0x7F
    with pytest.raises(WireVersionError, match="version"):
        wire.decode_frame(bytes(skew), "cpu")
    with pytest.raises(WireVersionError, match="too short"):
        wire.decode_frame(frame[:6], "cpu")
    with pytest.raises(WireCRCError, match="truncated"):
        wire.decode_frame(frame[:-5], "cpu")


# ---------------------------------------------------------------------------
# frames across the packages
# ---------------------------------------------------------------------------

def _fp_arrays(dtype, n=3, L=2, H=2, bs=8, hd=32, seed=4):
    rng = np.random.default_rng(seed)
    k, v = (rng.standard_normal((L, n, H, bs, hd)).astype(np.float32)
            for _ in range(2))
    if dtype == "bf16":
        k, v = (a.astype(ml_dtypes.bfloat16) for a in (k, v))
    return k, v


def _as_torch(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


@pytest.mark.parametrize("case", ["int8", "fp32_raw", "bf16_raw", "fp32_wire_quantized"])
def test_frames_are_byte_identical_across_packages(case):
    """The same pages encode to the same frame in both packages (int8 pools,
    raw fp32 and bf16 pages, and fp32 quantized at the wire); each package
    decodes the other's frame to the same pages."""
    n = 3
    seqs = [{"uid": 5, "n": n, "seen_tokens": 20, "tokens": list(range(20)),
             "skipped": 1, "skipped_digests": [b"\x07" * 32]}]
    if case == "int8":
        k, v, _ = _int8_arrays(n=n, rows=n)
        jh = {"n": n, "k": k, "v": v, "seqs": seqs}
        th = _handle(k, v, seqs, n)
    else:
        k, v = _fp_arrays("bf16" if case == "bf16_raw" else "fp32", n=n)
        jh = {"n": n, "k": k, "v": v, "seqs": seqs}
        th = {"n": n, "k": _as_torch(k), "v": _as_torch(v), "seqs": seqs}
    quantize = case == "fp32_wire_quantized"
    jframe = jax_wire.encode_handle(jh, wire_quantize=quantize)
    tframe = wire.encode_handle(th, wire_quantize=quantize)
    assert tframe == jframe
    # JAX frame -> port, port frame -> JAX: the same pages either way
    got = wire.decode_frame(jframe, "cpu")
    jgot = jax_wire.decode_frame(tframe)
    assert got["seqs"] == jgot["seqs"]
    for part in ("k", "v"):
        t, j = got[part], jgot[part]
        for a, b in zip(t if isinstance(t, tuple) else (t,),
                        j if isinstance(j, tuple) else (j,)):
            b = np.asarray(b)[:, :n]
            if a.dtype == torch.bfloat16:
                assert np.array_equal(a.view(torch.int16).numpy(),
                                      b.view(np.int16))
            else:
                np.testing.assert_array_equal(a.numpy(), b)


@pytest.fixture(scope="module")
def served():
    return served_models()


def test_jax_shipped_pages_serve_the_port_decode_round(served):
    """A JAX int8 engine's exported pages, framed by the JAX package, bind in
    a port engine, whose decode round then agrees with the JAX engine's
    (which bound the same frame) within 2e-5."""
    _, jmodel, params, model = served
    prompt = np.random.default_rng(8).integers(1, 512, 37).astype(np.int32)
    src = JaxEngine(jmodel, params, config=WIRE_ENG)
    first = src.put([0], [prompt])
    frame = jax_wire.encode_handle(src.export_pages_many([0]))
    jdst = JaxEngine(jmodel, params, config=WIRE_ENG)
    jdst.import_pages_many(jax_wire.decode_frame(frame))
    dst = InferenceEngineV2(model, WIRE_ENG, device="cpu")
    assert dst.import_pages_many(wire.decode_frame(frame, "cpu")) == 5
    tok = np.asarray([int(np.argmax(first[0]))], np.int32)
    np.testing.assert_allclose(dst.put([0], [tok]), jdst.put([0], [tok]),
                               atol=ATOL, rtol=0)


# ---------------------------------------------------------------------------
# flow control units
# ---------------------------------------------------------------------------

def test_flow_control_window_and_backpressure():
    f = FlowControl(max_inflight_bytes=100, link_gbps=8e-9)  # 1 byte/s
    f.open_round()
    assert f.admit("p0", "d0", 80)
    assert not f.admit("p0", "d0", 40), "window full -> defer"
    assert f.admit("p1", "d0", 500), "empty (src,dst) window always admits"
    assert f.inflight_bytes() == 580
    assert f.queued_bytes("p0") == 40
    assert f.backpressure_s("p0") == pytest.approx(40.0)
    assert f.backpressure_s("p1") == 0.0
    st = f.stats()
    assert st["deferrals"] == 1 and st["peak_inflight_bytes"] == 580
    f.open_round()
    assert f.queued_bytes() == 0 and f.inflight_bytes() == 0
    assert f.admit("p0", "d0", 40)


def test_router_prediction_includes_link_backpressure():
    class _Target:
        budget = 48

        def kv_stats(self):
            return {"occupancy": 0.0}

    class _Backend:
        def router_targets(self):
            return [(None, _Target()), (None, _Target())]

        def link_backpressure_s(self, i):
            return 2.5 if i == 0 else 0.0

    r = SLORouter(_Backend(), slo_ttft_s=1e9)
    assert r.predicted_ttft(0, 16) - r.predicted_ttft(1, 16) == pytest.approx(2.5)


# ---------------------------------------------------------------------------
# fleet integration over the serialized codec
# ---------------------------------------------------------------------------

def _run_fleet(model, prompts, max_new=6, **kw):
    kw.setdefault("engine_config", WIRE_ENG)
    kw.setdefault("token_budget", 48)
    kw.setdefault("prefill_replicas", 1)
    kw.setdefault("decode_replicas", 1)
    kw.setdefault("devices", ["cpu", "cpu"])
    fleet = PrefillDecodeFleet(model, codec="wire", **kw)
    for uid, p in prompts.items():
        fleet.submit(uid, p, max_new_tokens=max_new, temperature=0.0, seed=3)
    out = fleet.run_to_completion()
    return fleet, {u: np.asarray(v, np.int32) for u, v in out.items()}


def _as_reqs(prompts, max_new=6):
    return {u: (p, {"max_new_tokens": max_new, "temperature": 0.0, "seed": 3})
            for u, p in prompts.items()}


@pytest.fixture(scope="module")
def ref6(served):
    """The port's and the JAX package's monolithic greedy outputs for the
    prefix trace (int8 pools), each computed once."""
    jcfg, jmodel, params, model = served
    prompts = prefix_requests(jcfg.vocab_size)
    clean_state()
    want = single_reference(model, _as_reqs(prompts), eng=WIRE_ENG)
    jwant = jax_single_reference(jmodel, params, _as_reqs(prompts), eng=WIRE_ENG)
    return want, jwant


def test_delta_shipping_skips_held_prefix_blocks(served, ref6):
    """The wire codec end to end, without and with delta shipping: both equal
    the monolithic run (and the JAX package's) token for token; the frame
    undercuts the device page bytes, and the delta leg ships fewer bytes."""
    jcfg, _, _, model = served
    want, jwant = ref6
    assert_bit_exact(want, jwant)
    prompts = prefix_requests(jcfg.vocab_size)
    f_plain, got_plain = _run_fleet(model, prompts, delta_shipping=False)
    f_delta, got_delta = _run_fleet(model, prompts, delta_shipping=True)
    assert_bit_exact(got_plain, want)
    assert_bit_exact(got_delta, want)
    plain, delta = f_plain.transport.stats(), f_delta.transport.stats()
    assert plain["codec"] == "wire" and plain["wire_bytes_shipped"] > 0
    assert plain["crc_failures"] == 0 and plain["failed_handoffs"] == 0
    # a frame is the page bytes plus its header and meta (no padding rows)
    overhead = plain["wire_bytes_shipped"] - plain["bytes_shipped"]
    assert 0 < overhead < 2048 * plain["transfers"]
    assert delta["delta_shipping"] and not plain["delta_shipping"]
    assert delta["pages_delta_skipped"] > 0 and delta["wire_bytes_saved"] > 0
    assert delta["wire_bytes_shipped"] < plain["wire_bytes_shipped"]


def test_crc_corruption_retries_wire_leg_then_succeeds(served, ref6):
    jcfg, _, _, model = served
    prompts = prefix_requests(jcfg.vocab_size, pools=1, per_pool=2)
    faults.configure(spec="transport.corrupt:once")
    fleet, got = _run_fleet(model, prompts)
    assert_bit_exact(got, {u: ref6[0][u] for u in prompts})
    st = fleet.transport.stats()
    assert st["crc_failures"] == 1 and st["retry_trips"] >= 1
    assert st["failed_handoffs"] == 0 and fleet.handoff_fallbacks == 0


def test_crc_corruption_exhausted_falls_back_to_reprefill(served, ref6):
    jcfg, _, _, model = served
    prompts = prefix_requests(jcfg.vocab_size, pools=1, per_pool=2)
    faults.configure(spec="transport.corrupt:always")
    fleet, got = _run_fleet(model, prompts)
    faults.reset()
    assert_bit_exact(got, {u: ref6[0][u] for u in prompts})
    assert fleet.transport.stats()["failed_handoffs"] >= 1
    assert fleet.handoff_fallbacks == len(prompts)


def test_flow_control_accounts_ships_and_completes(served, ref6):
    jcfg, _, _, model = served
    flow = FlowControl(max_inflight_bytes=1)
    fleet, got = _run_fleet(model, prefix_requests(jcfg.vocab_size), flow=flow,
                            delta_shipping=True)
    assert_bit_exact(got, ref6[0])
    st = flow.stats()
    assert st["peak_inflight_bytes"] > 0
    assert fleet.load_report()["flow"] == st
    assert fleet.link_backpressure_s(0) == 0.0


def test_fleet_decode_speculative_default_on(served):
    jcfg, _, _, model = served
    prompts = prefix_requests(jcfg.vocab_size)
    want = single_reference(model, _as_reqs(prompts, max_new=8), eng=WIRE_ENG)
    fleet, got = _run_fleet(model, prompts, max_new=8)
    assert_bit_exact(got, want)
    assert fleet.decode[0][1]._spec
    assert not fleet.prefill[0][1]._spec


def test_with_speculative_default_gating():
    f = PrefillDecodeFleet._with_speculative_default
    m = LlamaForCausalLM(LlamaConfig.tiny(), device="meta")
    assert f(None, m)["speculative"] == {"enabled": True}
    assert f({}, m)["speculative"] == {"enabled": True}
    explicit = {"speculative": {"enabled": False}}
    assert f(explicit, m) is explicit

    from deepspeed_tpu_torch.models.opt import OPTConfig

    class _NoVerify:
        config = OPTConfig()
    assert f(None, _NoVerify()) is None
    assert f({}, _NoVerify()) == {}


def test_wire_telemetry_reports_true_wire_bytes(served):
    jcfg, _, _, model = served
    prompts = prefix_requests(jcfg.vocab_size)
    telemetry.configure(enabled=True, sample_sync=True)
    fleet, _ = _run_fleet(model, prompts)
    agg = telemetry.summary()["fleet"]["handoff"]
    st = fleet.transport.stats()
    assert agg["count"] == len(prompts)
    assert agg["wire_bytes"] == pytest.approx(st["wire_bytes_shipped"], rel=0.01)
    assert agg["bytes"] == st["bytes_shipped"]


def test_bf16_pool_wire_leg_quantizes_and_counts_its_bytes(served):
    """A bf16 pool's pages quantize at the wire: each page costs (hd + 4) /
    (2 hd) of its bf16 bytes, the destination binds bf16 pages within the
    8-bit grid's step of the source's, and the fleet completes."""
    jcfg, _, _, model = served
    m16 = LlamaForCausalLM(LlamaConfig.tiny(dtype=torch.bfloat16), device="cpu")
    m16.load_state_dict({k: v.to(torch.bfloat16) for k, v in model.state_dict().items()})
    eng = dict(WIRE_ENG, kv_cache={"block_size": 8, "cache_dtype": "bf16"},
               state_manager=dict(WIRE_ENG["state_manager"], kv_dtype="fp"))
    src = InferenceEngineV2(m16, eng, device="cpu")
    dst = InferenceEngineV2(m16, eng, device="cpu")
    src.put([0], [np.arange(1, 30, dtype=np.int32)])
    h = src.export_pages_many([0])
    k = h["k"].clone()
    frame = wire.encode_handle(h, wire_quantize=True)
    raw = wire.encode_handle(h, wire_quantize=False)
    hd = model.config.head_dim
    per_page = lambda f: (len(f) - 12 - int.from_bytes(f[8:12], "little")) // h["n"]
    assert per_page(frame) / per_page(raw) == pytest.approx((hd + 4) / (2 * hd))
    dst.import_pages_many(wire.decode_frame(frame, "cpu"))
    blocks = dst._state.get_sequence(0).kv_blocks
    got = dst._state.kv_cache.k_pool[:, blocks].float()
    step = k.float().abs().amax(-1, keepdim=True) / 127
    assert ((got - k.float()).abs() <= step).all()
    _, out = _run_fleet(m16, prefix_requests(jcfg.vocab_size), engine_config=eng)
    assert all(len(v) == 6 for v in out.values())


# ---------------------------------------------------------------------------
# two-process leg (a real OS process boundary)
# ---------------------------------------------------------------------------

def test_two_process_framing_roundtrip():
    import multiprocessing as mp
    a, b = mp.Pipe()
    _send(a, {"op": "ship", "adopts": [{"uid": 3}]}, b"\x00\x01payload")
    header, payload = _recv(b)
    assert header == {"op": "ship", "adopts": [{"uid": 3}]}
    assert payload == b"\x00\x01payload"
    _send(b, {"op": "ack", "bound": 5})
    header, payload = _recv(a)
    assert header == {"op": "ack", "bound": 5} and payload == b""
    a.close()
    b.close()


def test_two_process_fleet_matches_in_process_fleet():
    """Prefill parent + decode child in a separate OS process: every page
    crosses the pipe as a CRC32-checked frame, delta shipping works across
    the boundary, and the greedy streams equal the in-process fleet's under
    the same codec (and the monolithic run's: int8 pools ship losslessly).
    The child rebuilds the model from the seed."""
    cfg = LlamaConfig.tiny(dtype=torch.float32)
    model = LlamaForCausalLM.from_seed(cfg, 0, device="cpu")
    prompts = prefix_requests(cfg.vocab_size)
    want = single_reference(model, _as_reqs(prompts), eng=WIRE_ENG)
    _, in_process = _run_fleet(model, prompts, delta_shipping=True)
    assert_bit_exact(in_process, want)
    tp = TwoProcessFleet(model, seed=0, engine_config=WIRE_ENG, token_budget=48,
                         delta_shipping=True, device="cpu", decode_device="cpu")
    try:
        for uid, p in prompts.items():
            tp.submit(uid, p, max_new_tokens=6, temperature=0.0, seed=3)
        got = {u: np.asarray(v, np.int32) for u, v in tp.run_to_completion().items()}
    finally:
        tp.close()
    assert_bit_exact(got, in_process)
    st = tp.stats()
    assert st["handoffs"] == len(prompts)
    assert st["pages_delta_skipped"] > 0
    assert st["crc_naks"] == 0 and st["fallbacks"] == 0
    assert st["lost_requests"] == 0
