"""The port's Mixtral serving path against the JAX package's, on the CPU.

The same tiny Mixtral weights (drawn by flax from ``PRNGKey(0)``, carried
into the port through ``params_from_flax``) serve in both packages' v2
engines: ``put`` logits must match for a prefill, a prefill followed by
decode steps, and a mixed two-sequence ragged batch; a ``SplitFuseScheduler``
greedy run over mixed-length requests under a small token budget must give
identical token streams. The JAX engine routes its expert FFN through the
einsum dispatch on the CPU; the port's "auto" route is the grouped-GEMM
kernel's wrapper, which on CPU tensors runs the plain grouped version, and
the port's "einsum" pin runs the port's einsum dispatch. Also: the
``params_from_flax`` layout, module selection and pins, the entry points'
device default and the training forward's refusal.

Tolerances: fp32 weights, activations and KV on both sides; the forwards
differ only in matmul and reduction order, so 2e-5 absolute, as
``tests/test_torch_serving.py`` holds Llama. Greedy tokens must be identical.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JaxEngine
from deepspeed_tpu.inference.v2.scheduler import SplitFuseScheduler as JaxScheduler
from deepspeed_tpu.models.mixtral import MixtralConfig as JaxMixtralConfig
from deepspeed_tpu.models.mixtral import MixtralForCausalLM as JaxMixtral
from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,
                                              SplitFuseScheduler, build_engine)
from deepspeed_tpu_torch.inference.v2.engine_factory import resolve_forward_fn, resolve_verify_fn
from deepspeed_tpu_torch.inference.v2.model_implementations import mixtral as mx
from deepspeed_tpu_torch.inference.v2.modules import (UnknownModuleError,
                                                      UnsupportedModuleError)
from deepspeed_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from deepspeed_tpu_torch.models.mixtral import (MixtralConfig,
                                                MixtralForCausalLM,
                                                params_from_flax)
from deepspeed_tpu_torch.ops.grouped_gemm import grouped_matmul

ATOL = 2e-5


@pytest.fixture(scope="module")
def served():
    jcfg = JaxMixtralConfig.tiny(dtype=jnp.float32, remat=False)
    jmodel = JaxMixtral(jcfg)
    ids = np.random.default_rng(0).integers(0, jcfg.vocab_size,
                                            (1, 8)).astype(np.int32)
    params = jmodel.init(jax.random.PRNGKey(0), {"input_ids": ids})["params"]
    model = MixtralForCausalLM(MixtralConfig.tiny(dtype=torch.float32))
    model.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    return jmodel, params, model


def engine_config(max_seqs=8, budget=64, blocks=32, moe="auto"):
    return {"state_manager": {"max_ragged_sequence_count": max_seqs,
                              "max_ragged_batch_size": budget,
                              "max_context": 128, "num_kv_blocks": blocks},
            "kv_cache": {"block_size": 8, "cache_dtype": "fp32"},
            "modules": {"moe": moe}}


def engines(served, moe="auto", **kw):
    jmodel, params, model = served
    return (JaxEngine(jmodel, params, config=engine_config(**kw)),
            InferenceEngineV2(model, engine_config(moe=moe, **kw), device="cpu"))


def put_both(pair, uids, toks):
    ref, ours = pair[0].put(uids, toks), pair[1].put(uids, toks)
    np.testing.assert_allclose(ours, ref, atol=ATOL, rtol=0)
    assert (ours.argmax(-1) == ref.argmax(-1)).all()
    return ours


def test_params_from_flax_layout(served):
    _, params, model = served
    sd = params_from_flax(jax.tree.map(np.asarray, params))
    assert set(sd) == set(model.state_dict())
    lp = params["layers_1"]
    q = np.asarray(lp["self_attn"]["q_proj"]["kernel"])          # [in, out]
    np.testing.assert_array_equal(sd["layers.1.self_attn.q_proj.weight"], q.T)
    wg = np.asarray(lp["block_sparse_moe"]["gate"]["wg"])
    assert wg.shape == (64, 4)
    np.testing.assert_array_equal(sd["layers.1.block_sparse_moe.gate.wg"], wg)
    ex = lp["block_sparse_moe"]["experts"]["MixtralExpertMLP_0"]
    for n, shape in (("w1", (4, 64, 128)), ("w3", (4, 64, 128)),
                     ("w2", (4, 128, 64))):
        assert tuple(sd[f"layers.1.block_sparse_moe.experts.{n}"].shape) == shape
        np.testing.assert_array_equal(sd[f"layers.1.block_sparse_moe.experts.{n}"],
                                      np.asarray(ex[n]["kernel"]))
    assert model.config.num_parameters() == sum(v.numel() for v in sd.values())


@pytest.mark.parametrize("moe", ["auto", "einsum"])
def test_prefill_matches_jax(served, moe):
    pair = engines(served, moe=moe)
    ids = np.random.default_rng(1).integers(0, 512, 11).astype(np.int32)
    put_both(pair, [7], [ids])


@pytest.mark.parametrize("moe", ["auto", "einsum"])
def test_prefill_then_decode_matches_jax(served, moe):
    pair = engines(served, moe=moe)
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


def _requests(seed=6):
    rng = np.random.default_rng(seed)
    return {uid: rng.integers(0, 512, L).astype(np.int32)
            for uid, L in enumerate([5, 23, 40, 9, 31, 60])}


def _serve(sched, prompts):
    for uid, p in prompts.items():
        sched.submit(uid, p, max_new_tokens=8)
    return {u: t.tolist() for u, t in sched.run_to_completion().items()}


def test_splitfuse_greedy_streams_identical_to_jax(served):
    jax_engine, engine = engines(served, max_seqs=4, budget=16, blocks=64)
    prompts = _requests()
    ref = _serve(JaxScheduler(jax_engine, token_budget=16), prompts)
    ours = _serve(SplitFuseScheduler(engine, token_budget=16), prompts)
    assert ours == ref
    assert engine.free_blocks == jax_engine.free_blocks == 64


def test_routes_record_and_replay(served):
    """``routes`` collects one (top_vals, top_idx) pair per layer, and a
    forward that replays them gives the same logits."""
    _, _, model = served
    engine = InferenceEngineV2(model, engine_config(), device="cpu")
    ids = np.random.default_rng(9).integers(0, 512, 13).astype(np.int32)
    want = engine.put([1], [ids])
    from deepspeed_tpu_torch.inference.v2.ragged.kv_cache import BlockedKVCache
    from deepspeed_tpu_torch.inference.v2.ragged.ragged_wrapper import (
        RaggedBatchWrapper)
    w = RaggedBatchWrapper(8, 64, 16, 2)
    w.insert_sequence(0, ids, 0, [0, 1])
    a = {k: torch.from_numpy(v) for k, v in w.build().items()}

    def run(routes):
        kv = BlockedKVCache(2, 2, 8, 2, 16, "fp32", device="cpu")
        return mx.ragged_forward(model, kv, a["tokens"], a["q_len"], a["seen"],
                                 a["block_tables"], routes=routes)[0].numpy()

    routes = []
    np.testing.assert_allclose(run(routes), want[0], atol=ATOL, rtol=0)
    assert len(routes) == 2 and routes[0][1].shape == (4 * 16, 2)   # [S, Q] bucket
    np.testing.assert_array_equal(run(routes), run(None))


def test_moe_selection_and_pins(served):
    _, _, model = served
    ids = np.random.default_rng(8).integers(0, 512, 12).astype(np.int32)
    auto = InferenceEngineV2(model, engine_config(), device="cpu")
    pinned = InferenceEngineV2(model, engine_config(moe="einsum"), device="cpu")
    explicit = InferenceEngineV2(model, engine_config(moe="cuda_gmm"),
                                 device="cpu")
    assert (auto.moe_impl, pinned.moe_impl, explicit.moe_impl) == \
        ("cuda_gmm", "einsum", "cuda_gmm")
    assert auto.attention_impl == "cuda_paged"
    launches = grouped_matmul.launches
    np.testing.assert_allclose(auto.put([1], [ids]), pinned.put([1], [ids]),
                               atol=ATOL, rtol=0)
    assert grouped_matmul.launches == launches         # CPU: nothing launched
    with pytest.raises(UnknownModuleError, match="megablox"):
        InferenceEngineV2(model, engine_config(moe="megablox"), device="cpu")
    llama = LlamaForCausalLM(LlamaConfig.tiny(dtype=torch.float32))
    assert InferenceEngineV2(llama, engine_config(), device="cpu").moe_impl is None
    for name in ("einsum", "cuda_gmm", "megablox"):
        with pytest.raises(UnsupportedModuleError, match="no MoE layer"):
            InferenceEngineV2(llama, engine_config(moe=name), device="cpu")


def test_factory_routes_families(served):
    _, _, model = served
    assert resolve_forward_fn(model) is mx.ragged_forward
    assert resolve_forward_fn(model, family="mixtral") is mx.ragged_forward
    from deepspeed_tpu_torch.inference.v2.model_implementations import opt, parallel_block
    assert resolve_forward_fn(model, family="falcon") is parallel_block.ragged_forward
    assert resolve_forward_fn(model, family="phi") is parallel_block.ragged_forward
    assert resolve_forward_fn(model, family="opt") is opt.ragged_forward
    assert resolve_verify_fn(model) is None


def test_entry_points_run_on_cuda_unless_told_otherwise(served):
    _, _, model = served
    if torch.cuda.is_available():
        with pytest.raises(ValueError, match="weights are on cpu"):
            build_engine(model, engine_config())
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_engine(model, engine_config())
        with pytest.raises(RuntimeError, match="no CUDA device"):
            MixtralForCausalLM.from_seed(MixtralConfig.tiny(), seed=0)
    engine = build_engine(model, engine_config(), device="cpu")
    assert engine.device.type == "cpu" and engine.moe_impl == "cuda_gmm"


def test_training_forward_raises(served):
    """The training forward runs on the served weights
    (``tests/test_torch_mixtral_train.py`` holds it to the JAX model); what it
    cannot take raises: fp16 products under the grouped-GEMM dispatch
    (megablox's dtype error) and an unknown dispatch mode."""
    _, _, model = served
    ids = torch.zeros(1, 8, dtype=torch.long)
    with torch.no_grad():
        assert torch.isfinite(model({"input_ids": ids, "labels": ids}))
    half = MixtralForCausalLM(MixtralConfig.tiny(dtype=torch.float16,
                                                 moe_backend="gmm"))
    half.load_state_dict(model.state_dict())
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        half({"input_ids": ids, "labels": ids})
    with pytest.raises(ValueError, match="dispatch_mode"):
        MixtralForCausalLM(MixtralConfig.tiny(moe_backend="dense"))


def test_from_seed_and_config():
    a = MixtralForCausalLM.from_seed(MixtralConfig.tiny(), seed=3, device="cpu")
    b = MixtralForCausalLM.from_seed(MixtralConfig.tiny(), seed=3, device="cpu")
    for (n, x), (_, y) in zip(a.state_dict().items(), b.state_dict().items()):
        assert torch.equal(x, y), n
    moe = a.layers[0].block_sparse_moe
    assert moe.experts.w1.dtype == torch.bfloat16
    assert tuple(moe.experts.w2.shape) == (4, 128, 64)
    assert tuple(moe.gate.wg.shape) == (64, 4)
    assert a.norm.weight.dtype == torch.float32
    big = MixtralConfig.mixtral_8x7b()
    assert (big.head_dim, big.num_local_experts, big.intermediate_size,
            big.rope_theta) == (128, 8, 14336, 1e6)
    assert abs(big.num_parameters() / 1e9 - 46.70) < 0.01
    llama = big.as_llama()
    assert (llama.num_key_value_heads, llama.head_dim) == (8, 128)
