"""The port's FastGen serving path against the JAX package's, on the CPU.

The same tiny Llama weights (drawn by flax from ``PRNGKey(0)``, carried into
the port through ``params_from_flax``) serve in both packages:
``InferenceEngineV2.put`` logits must match for prefill, decode, a mixed
ragged batch, a sliding window and int8 KV pages; block accounting and
admission control must agree; a ``SplitFuseScheduler`` greedy run over
mixed-length requests under a small token budget must give identical token
streams. Inside the port: prefix caching on/off and preemption under KV
pressure leave greedy streams bit-exact, and seeded sampling is a function
of (seed, position) alone. Mirrors ``tests/test_inference_v2.py:45-111``,
``tests/test_splitfuse_scheduler.py`` and ``tests/test_prefix_cache.py``.

Tolerances: both packages run fp32 weights, activations and KV; the
forwards differ only in matmul and reduction order (XLA vs PyTorch CPU
kernels), which moves logits of magnitude ~0.5 by ~1e-6, so 2e-5 absolute.
Greedy tokens must be identical.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JaxEngine
from deepspeed_tpu.inference.v2.scheduler import SplitFuseScheduler as JaxScheduler
from deepspeed_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from deepspeed_tpu.models.llama import LlamaForCausalLM as JaxLlama
from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,
                                              SplitFuseScheduler, build_engine)
from deepspeed_tpu_torch.inference.v2.modules import (UnknownModuleError,
                                                      UnsupportedModuleError)
from deepspeed_tpu_torch.inference.v2.sampling import sample_rows
from deepspeed_tpu_torch.models.llama import (LlamaConfig, LlamaForCausalLM,
                                              params_from_flax)
from deepspeed_tpu_torch.ops.paged_attention import paged_mha

ATOL = 2e-5


def _models(window=None):
    jcfg = JaxLlamaConfig.tiny(scan_layers=True, remat=False,
                               dtype=jnp.float32, sliding_window=window)
    jmodel = JaxLlama(jcfg)
    ids = np.random.default_rng(0).integers(0, jcfg.vocab_size,
                                            (1, 8)).astype(np.int32)
    params = jmodel.init(jax.random.PRNGKey(0), {"input_ids": ids})["params"]
    model = LlamaForCausalLM(LlamaConfig.tiny(dtype=torch.float32,
                                              sliding_window=window))
    model.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    return jmodel, params, model


@pytest.fixture(scope="module")
def served():
    return _models()


def engine_config(max_seqs=8, budget=64, blocks=32, kv_dtype="fp",
                  prefix_caching=False, attention="auto"):
    return {"state_manager": {"max_ragged_sequence_count": max_seqs,
                              "max_ragged_batch_size": budget,
                              "max_context": 128, "num_kv_blocks": blocks,
                              "kv_dtype": kv_dtype},
            "kv_cache": {"block_size": 8, "cache_dtype": "fp32"},
            "modules": {"attention": attention},
            "prefix_caching": prefix_caching}


def engines(served, **kw):
    jmodel, params, model = served
    ecfg = engine_config(**kw)
    return (JaxEngine(jmodel, params, config=ecfg),
            InferenceEngineV2(model, ecfg, device="cpu"))


def put_both(pair, uids, toks):
    ref, ours = pair[0].put(uids, toks), pair[1].put(uids, toks)
    np.testing.assert_allclose(ours, ref, atol=ATOL, rtol=0)
    assert (ours.argmax(-1) == ref.argmax(-1)).all()
    return ours


def test_params_from_flax_layout(served):
    jmodel, params, model = served
    sd = params_from_flax(jax.tree.map(np.asarray, params))
    assert set(sd) == set(model.state_dict())
    k = np.asarray(params["layers"]["block"]["self_attn"]["k_proj"]["kernel"])
    assert k.shape == (2, 64, 32)                       # flax [L, in, out]
    assert tuple(sd["layers.1.self_attn.k_proj.weight"].shape) == (32, 64)
    np.testing.assert_array_equal(sd["layers.1.self_attn.k_proj.weight"],
                                  k[1].T)


def test_prefill_matches_jax(served):
    pair = engines(served)
    ids = np.random.default_rng(1).integers(0, 512, 11).astype(np.int32)
    put_both(pair, [7], [ids])


def test_prefill_then_decode_matches_jax(served):
    pair = engines(served)
    ids = np.random.default_rng(2).integers(0, 512, 6).astype(np.int32)
    logits = put_both(pair, [1], [ids])
    for _ in range(4):
        nxt = np.asarray([np.argmax(logits[0])], np.int32)
        logits = put_both(pair, [1], [nxt])


def test_mixed_ragged_batch_matches_jax(served):
    pair = engines(served)
    rng = np.random.default_rng(3)
    a = rng.integers(0, 512, 9).astype(np.int32)
    b = rng.integers(0, 512, 17).astype(np.int32)
    out = put_both(pair, [10, 11], [a, b])
    c = rng.integers(0, 512, 5).astype(np.int32)
    nxt_a = np.asarray([np.argmax(out[0])], np.int32)
    put_both(pair, [10, 12], [nxt_a, c])      # decode mixed with a prefill


def test_sliding_window_matches_jax():
    pair = engines(_models(window=6))
    rng = np.random.default_rng(4)
    a = rng.integers(0, 512, 13).astype(np.int32)
    b = rng.integers(0, 512, 3).astype(np.int32)
    out = put_both(pair, [1, 2], [a, b])
    put_both(pair, [1, 2], [np.asarray([np.argmax(r)], np.int32) for r in out])


def test_int8_kv_matches_jax_and_stays_near_fp(served):
    """int8 pages quantize on write per (token, kv head) row exactly as the
    JAX package does, so the two packages agree to fp32 order; against fp
    pages the logits move by the int8 rounding of K and V (|err| <= 1/254 of
    each row's max), observed ~1e-3 here, bounded at 2e-2."""
    pair = engines(served, kv_dtype="int8")
    fp = engines(served)[1]
    rng = np.random.default_rng(5)
    ids = rng.integers(0, 512, 14).astype(np.int32)
    out = put_both(pair, [3], [ids])
    np.testing.assert_allclose(out, fp.put([3], [ids]), atol=2e-2, rtol=0)
    for _ in range(3):
        nxt = np.asarray([np.argmax(out[0])], np.int32)
        out = put_both(pair, [3], [nxt])
        np.testing.assert_allclose(out, fp.put([3], [nxt]), atol=2e-2, rtol=0)


def test_block_accounting_and_admission_match_jax(served):
    jax_engine, engine = engines(served)
    free0 = engine.free_blocks
    assert free0 == jax_engine.free_blocks
    ids = np.arange(20, dtype=np.int32)
    put_both((jax_engine, engine), [42], [ids])
    used = free0 - engine.free_blocks
    assert used == -(-20 // 8) == free0 - jax_engine.free_blocks
    assert engine.get_remaining_block_capacity(42) == used * 8 - 20
    engine.flush(42)
    assert engine.free_blocks == free0
    for uids, lens in (([1, 2], [4, 4]), ([3], [200]), ([1], [65]),
                       ([1, 1], [2, 2]), ([5], [8 * 33])):
        a = engine.can_schedule(uids, lens)
        b = jax_engine.can_schedule(uids, lens)
        assert (a.success, a.reason) == (b.success, b.reason)
    assert engine.query(9, 40, 3) == jax_engine.query(9, 40, 3)


def _requests(n=6, seed=6):
    rng = np.random.default_rng(seed)
    lens = [5, 23, 40, 9, 31, 60][:n]
    return {uid: rng.integers(0, 512, L).astype(np.int32)
            for uid, L in enumerate(lens)}


def _serve(sched, prompts, **kw):
    for uid, p in prompts.items():
        sched.submit(uid, p, max_new_tokens=8, **kw)
    return {u: t.tolist() for u, t in sched.run_to_completion().items()}


def test_splitfuse_greedy_streams_identical_to_jax(served):
    jax_engine, engine = engines(served, max_seqs=4, budget=16, blocks=64)
    prompts = _requests()
    ref = _serve(JaxScheduler(jax_engine, token_budget=16), prompts)
    ours = _serve(SplitFuseScheduler(engine, token_budget=16), prompts)
    assert ours == ref
    assert engine.free_blocks == jax_engine.free_blocks == 64


def test_host_sampling_path_matches_device_greedy(served):
    _, _, model = served
    prompts = _requests(4)
    a = _serve(SplitFuseScheduler(InferenceEngineV2(
        model, engine_config(max_seqs=4, budget=16, blocks=64), device="cpu"),
        token_budget=16), prompts)
    b = _serve(SplitFuseScheduler(InferenceEngineV2(
        model, engine_config(max_seqs=4, budget=16, blocks=64), device="cpu"),
        token_budget=16, device_sampling=False), prompts)
    assert a == b


def test_prefix_caching_on_off_bit_exact(served):
    _, _, model = served
    rng = np.random.default_rng(20)
    pool = rng.integers(0, 512, 24).astype(np.int32)
    prompts = {u: np.concatenate([pool, rng.integers(0, 512, n).astype(np.int32)])
               for u, n in enumerate([5, 9, 2])}

    def run(caching):
        engine = InferenceEngineV2(model, engine_config(
            max_seqs=4, budget=16, blocks=64, prefix_caching=caching),
            device="cpu")
        sched = SplitFuseScheduler(engine, token_budget=16)
        sched.submit(0, prompts[0], max_new_tokens=6)
        sched.run_to_completion()          # request 0 fills the cache
        out = _serve(sched, {u: p for u, p in prompts.items() if u}, )
        return out, sched

    off, _ = run(False)
    on, sched = run(True)
    assert on == off
    assert sched.prefill_tokens_saved >= 2 * 24
    assert sched.engine.kv_stats()["prefix_hits"] >= 2


def test_preemption_under_kv_pressure_keeps_streams(served):
    """10 blocks x 8 tokens cannot hold both 44-token requests and their 6
    new tokens: the scheduler swaps one to host memory and resumes it, and
    the streams equal an unpressured run's."""
    _, _, model = served
    rng = np.random.default_rng(7)
    prompts = {0: rng.integers(0, 512, 44).astype(np.int32),
               1: rng.integers(0, 512, 44).astype(np.int32)}

    def run(blocks):
        engine = InferenceEngineV2(model, engine_config(
            max_seqs=4, budget=16, blocks=blocks), device="cpu")
        sched = SplitFuseScheduler(engine, token_budget=16)
        for uid, p in prompts.items():
            sched.submit(uid, p, max_new_tokens=6)
        return ({u: t.tolist() for u, t in sched.run_to_completion().items()},
                engine)

    roomy, _ = run(64)
    tight, engine = run(10)
    assert tight == roomy
    assert engine.swap_stats["swap_outs"] >= 1
    assert engine.swap_stats["swap_ins"] >= 1


def test_swapped_sequence_cannot_schedule(served):
    _, _, model = served
    engine = InferenceEngineV2(model, engine_config(), device="cpu")
    engine.put([7], [np.arange(10, dtype=np.int32)])
    engine.preempt(7)
    assert "swapped" in engine.can_schedule([7], [1]).reason
    with pytest.raises(RuntimeError, match="swapped"):
        engine.put([7], [np.asarray([1], np.int32)])
    engine.resume(7)
    assert engine.can_schedule([7], [1]).success


def test_seeded_sampling_depends_on_seed_and_position_only():
    logits = torch.randn(6, 512, generator=torch.Generator().manual_seed(0))
    row = logits[2:3].repeat(6, 1)
    temps, ks, ps = [0.9] * 6, [40] * 6, [0.95] * 6
    a = sample_rows(row, temps, ks, ps, [5] * 6, [3] * 6)
    assert len(set(a.tolist())) == 1       # same (seed, position): same token
    b = sample_rows(row, temps, ks, ps, [5] * 6, list(range(6)))
    c = sample_rows(row, temps, ks, ps, [5] * 6, list(range(6)))
    assert torch.equal(b, c)
    greedy = sample_rows(logits, [0.0] * 6, [0] * 6, [1.0] * 6, [1] * 6,
                         [0] * 6)
    assert torch.equal(greedy, logits.argmax(-1).int())
    top1 = sample_rows(logits, [1.3] * 6, [1] * 6, [1.0] * 6, [1] * 6,
                       [0] * 6)
    assert torch.equal(top1, greedy)        # top_k = 1 is greedy


def test_sampled_streams_reproducible_across_batches(served):
    """A request's sampled stream is the same served alone or beside
    others: each draw keys on (seed, position)."""
    _, _, model = served
    prompts = _requests(3)
    kw = dict(temperature=0.8, top_k=50, top_p=0.9, seed=1234)

    def run(ps):
        engine = InferenceEngineV2(model, engine_config(
            max_seqs=4, budget=16, blocks=64), device="cpu")
        return _serve(SplitFuseScheduler(engine, token_budget=16), ps, **kw)

    together = run(prompts)
    alone = run({1: prompts[1]})
    assert together[1] == alone[1]
    assert all(0 <= t < 512 for s in together.values() for t in s)


def test_attention_selection_and_pins(served):
    _, _, model = served
    ids = np.random.default_rng(8).integers(0, 512, 12).astype(np.int32)
    auto = InferenceEngineV2(model, engine_config(), device="cpu")
    dense = InferenceEngineV2(model, engine_config(attention="dense"),
                              device="cpu")
    assert auto.attention_impl == "cuda_paged"
    assert dense.attention_impl == "dense"
    launches = paged_mha.launches
    np.testing.assert_array_equal(auto.put([1], [ids]), dense.put([1], [ids]))
    assert paged_mha.launches == launches          # CPU: nothing launched
    with pytest.raises(UnknownModuleError, match="pallas_paged"):
        InferenceEngineV2(model, engine_config(attention="pallas_paged"),
                          device="cpu")
    for mods in ({"moe": "einsum"}, {"linear": "fused_dequant"}):
        cfg = engine_config()
        cfg["modules"].update(mods)
        with pytest.raises(UnsupportedModuleError):
            InferenceEngineV2(model, cfg, device="cpu")


def test_entry_points_run_on_cuda_unless_told_otherwise(served):
    _, _, model = served
    if torch.cuda.is_available():
        with pytest.raises(ValueError, match="weights are on cpu"):
            build_engine(model, engine_config())
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_engine(model, engine_config())
        with pytest.raises(RuntimeError, match="no CUDA device"):
            LlamaForCausalLM.from_seed(LlamaConfig.tiny(), seed=0)
    assert build_engine(model, engine_config(), device="cpu").device.type == "cpu"


def test_from_seed_is_deterministic():
    a = LlamaForCausalLM.from_seed(LlamaConfig.tiny(), seed=3, device="cpu")
    b = LlamaForCausalLM.from_seed(LlamaConfig.tiny(), seed=3, device="cpu")
    for (n, x), (_, y) in zip(a.state_dict().items(), b.state_dict().items()):
        assert torch.equal(x, y), n
    assert a.layers[0].self_attn.q_proj.weight.dtype == torch.bfloat16
    assert a.norm.weight.dtype == torch.float32
    assert torch.equal(a.norm.weight, torch.ones(64))
