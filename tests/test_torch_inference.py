"""The port's v1 inference path (``init_inference``, the KV-cached Llama
forward, ``generate``, weight quantization) against the JAX package's, on
the CPU.

The same tiny Llama weights (drawn by flax from ``PRNGKey(0)``) serve in
both packages, carried into the port by ``params_from_flax``. The JAX
engines and the port's run fp32, so logits agree to 2e-5 (matmul and
reduction order only; logits are of order 0.5) and greedy tokens exactly,
unquantized and with ``quant`` at 8, 4, 6 and 12 bits: the port reproduces
v1's rounding of the dequantized weights to bf16 in an fp32 engine. Every
quantized leaf's codes and scales equal the JAX tree's bit for bit. Sampled
streams are held inside the port only: JAX's threefry stream cannot be
matched. Mirrors ``tests/test_inference.py`` and the quantized-serving cases
of ``tests/test_fp_quantizer.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.inference.quantization.quantization import (
    quantized_nbytes as jax_nbytes)
from deepspeed_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from deepspeed_tpu.models.llama import LlamaForCausalLM as JaxLlama
from deepspeed_tpu_torch.inference.generation import generate, init_cache, sample_logits
from deepspeed_tpu_torch.inference.quantization import QuantizedLinear, quantized_nbytes
from deepspeed_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM, params_from_flax

ATOL = 2e-5
BITS = [None, 8, 4, 6, 12]


def ids(seed, shape=(2, 8), vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


@pytest.fixture(scope="module")
def tiny():
    jcfg = JaxLlamaConfig.tiny(scan_layers=True, remat=False, dtype=jnp.float32)
    jmodel = JaxLlama(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0), {"input_ids": ids(0)})["params"]
    return jmodel, params, jax.tree.map(np.asarray, params)


def port_model(tiny, **kw):
    model = LlamaForCausalLM(LlamaConfig.tiny(dtype=torch.float32, **kw))
    model.load_state_dict(params_from_flax(tiny[2]))
    return model.eval().requires_grad_(False)


def quant_config(bits, dtype="fp32"):
    conf = {"dtype": dtype}
    if bits:
        conf["quant"] = {"enabled": True, "bits": bits, "group_size": 256}
    return conf


# -- the cached forward and generation (mirrors tests/test_inference.py) -----

@pytest.mark.parametrize("window", [None, 4])
def test_cached_prefill_matches_full_forward(tiny, window):
    model = port_model(tiny, sliding_window=window)
    x = torch.from_numpy(ids(1))
    with torch.no_grad():
        full = model(x)
        cached, cache = model(x, use_cache=True, cache=init_cache(model, x))
    np.testing.assert_allclose(cached.numpy(), full.numpy(), rtol=0, atol=ATOL)
    assert cache.index == 8 and cache.keys[0].shape == (2, 2, 128, 16)
    jm = JaxLlama(JaxLlamaConfig.tiny(scan_layers=True, remat=False, dtype=jnp.float32,
                                      sliding_window=window))
    from deepspeed_tpu.inference.generation import init_cache as jax_init_cache
    want, _ = jm.apply({"params": tiny[1], "cache": jax_init_cache(jm, ids(1))},
                       {"input_ids": ids(1)}, use_cache=True, mutable=["cache"])
    np.testing.assert_allclose(cached.numpy(), np.asarray(want), rtol=0, atol=ATOL)


def test_incremental_decode_matches_prefill(tiny):
    model = port_model(tiny)
    x = torch.from_numpy(ids(2, (1, 6)))
    with torch.no_grad():
        full = model(x)
        cache = init_cache(model, x)
        steps = []
        for t in range(6):
            logits, cache = model(x[:, t:t + 1], positions=torch.full((1, 1), t),
                                  use_cache=True, cache=cache)
            steps.append(logits[:, 0])
    np.testing.assert_allclose(torch.stack(steps, 1).numpy(), full.numpy(), rtol=0, atol=ATOL)


def test_greedy_generate_matches_naive_loop(tiny):
    model = port_model(tiny)
    cur = torch.from_numpy(ids(3, (2, 5))).long()
    out = generate(model, cur, max_new_tokens=6)
    naive = []
    with torch.no_grad():
        for _ in range(6):
            nxt = model(cur)[:, -1].argmax(-1)
            naive.append(nxt)
            cur = torch.cat([cur, nxt[:, None]], 1)
    assert torch.equal(out, torch.stack(naive, 1))


def test_eos_early_stop(tiny):
    model = port_model(tiny)
    x = ids(4, (1, 4))
    greedy = generate(model, x, max_new_tokens=5)
    eos = int(greedy[0, 1])                  # force EOS at step 2
    out = generate(model, x, max_new_tokens=5, eos_token_id=eos)
    assert (out[0, 2:] == eos).all() and torch.equal(out[0, :2], greedy[0, :2])


def test_window_overflow_raises(tiny):
    model = port_model(tiny)
    with pytest.raises(ValueError, match="max_position_embeddings=128"):
        generate(model, ids(5, (1, 120)), max_new_tokens=10)


def test_sampling_respects_top_k_and_top_p():
    logits = torch.tensor([[0.0, 1.0, 2.0, 3.0]])
    for seed in range(20):
        g = torch.Generator().manual_seed(seed)
        assert int(sample_logits(logits, g, temperature=1.0, top_k=2)[0]) in (2, 3)
        # softmax mass of 3 is 0.64: top_p 0.5 keeps it alone
        assert int(sample_logits(logits, g, temperature=1.0, top_p=0.5)[0]) == 3
    assert int(sample_logits(logits, None, temperature=0.0)[0]) == 3


def test_sampled_streams_are_seeded(tiny):
    """Sampling inside the port: a seed gives one stream; tokens in range."""
    engine = deepspeed_tpu_torch.init_inference(port_model(tiny), config={"dtype": "fp32"},
                                                device="cpu")
    x = ids(6)
    a = engine.generate(x, max_new_tokens=8, temperature=1.0, top_k=50, rng=7)
    b = engine.generate(x, max_new_tokens=8, temperature=1.0, top_k=50, rng=7)
    c = engine.generate(x, max_new_tokens=8, temperature=1.0, top_k=50, rng=8)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert ((a >= 0) & (a < 512)).all()


def test_engine_api(tiny):
    engine = deepspeed_tpu_torch.init_inference(
        LlamaForCausalLM(LlamaConfig.tiny(dtype=torch.float32)),
        config={"dtype": "fp32", "tensor_parallel": {"tp_size": 1}, "max_out_tokens": 5},
        device="cpu")
    engine.set_params(params_from_flax(tiny[2]))
    x = ids(5, (1, 4))
    logits = engine(x)
    assert logits.shape == (1, 4, 512)
    assert engine.generate(x, max_new_tokens=3).shape == (1, 3)
    assert engine.generate(x, max_new_tokens=30).shape == (1, 5)   # max_out_tokens
    engine.destroy()


def test_engine_without_params_raises():
    with torch.device("meta"):
        model = LlamaForCausalLM(LlamaConfig.tiny(dtype=torch.float32))
    engine = deepspeed_tpu_torch.init_inference(model, config={"dtype": "fp32"}, device="cpu")
    with pytest.raises(RuntimeError, match="no parameters"):
        engine(ids(0))


# -- parity with the JAX v1 engine -------------------------------------------

@pytest.mark.parametrize("bits", BITS)
def test_v1_parity_with_jax(tiny, bits):
    jmodel, params, np_params = tiny
    conf = quant_config(bits)
    jax_engine = deepspeed_tpu.init_inference(jmodel, config=conf, params=params)
    engine = deepspeed_tpu_torch.init_inference(
        LlamaForCausalLM(LlamaConfig.tiny(dtype=torch.float32)), config=conf,
        params=np_params, device="cpu")
    x = ids(7)
    np.testing.assert_allclose(engine(x).numpy(), np.asarray(jax_engine(x)), rtol=0,
                               atol=ATOL)
    assert np.array_equal(engine.generate(x, max_new_tokens=8).numpy(),
                          np.asarray(jax_engine.generate(x, max_new_tokens=8)))
    assert quantized_nbytes(engine.module) == jax_nbytes(jax_engine.params)


@pytest.mark.parametrize("bits", [8, 4, 6, 12])
def test_quantized_leaves_equal_jax(tiny, bits):
    """Each layer's codes and scales are that layer's part of the JAX
    engine's scan-stacked leaf (groups of 256 never straddle two layers
    here), and lm_head's are JAX's."""
    jmodel, params, np_params = tiny
    conf = quant_config(bits)
    jtree = deepspeed_tpu.init_inference(jmodel, config=conf, params=params).params
    module = deepspeed_tpu_torch.init_inference(
        LlamaForCausalLM(LlamaConfig.tiny(dtype=torch.float32)), config=conf,
        params=np_params, device="cpu").module
    blk = jtree["layers"]["block"]
    checked = 0
    for name, m in module.named_modules():
        if not isinstance(m, QuantizedLinear):
            continue
        if name == "lm_head":
            jq, js = jtree["lm_head"].q, jtree["lm_head"].scale
            parts = [(np.asarray(jq), np.asarray(js))]
            i = 0
        else:
            _, i, group, proj = name.split(".")
            leaf = blk[group][proj]["kernel"]
            parts = list(zip(np.split(np.asarray(leaf.q).reshape(-1), 2),
                             np.split(np.asarray(leaf.scale).reshape(-1), 2)))
            i = int(i)
        q, s = parts[i]
        assert np.array_equal(q.reshape(-1), m.q.numpy().reshape(-1)), name
        assert np.array_equal(s.reshape(-1), m.scale.numpy().reshape(-1)), name
        checked += 1
    assert checked == 2 * 7 + 1


def test_linear_routes_by_dtype_and_bits(tiny, caplog):
    """bf16 at 8 bits: every Dense kernel on the kernel row, lm_head on
    dense_dequant; fp32 or fp16 serving and 4-bit weights: dense_dequant.
    The kernel row refuses activations of another dtype than its tile's."""
    def impls(conf):
        engine = deepspeed_tpu_torch.init_inference(port_model(tiny), config=conf,
                                                    device="cpu")
        return engine, {n: m.impl for n, m in engine.module.named_modules()
                        if isinstance(m, QuantizedLinear)}
    engine, bf16 = impls(quant_config(8, "bf16"))
    assert bf16.pop("lm_head") == "dense_dequant"
    assert set(bf16.values()) == {"cuda_fused_dequant"}
    for conf in (quant_config(8, "fp32"), quant_config(8, "fp16"), quant_config(4, "bf16")):
        assert set(impls(conf)[1].values()) == {"dense_dequant"}
    q_proj = engine.module.layers[0].self_attn.q_proj
    with pytest.raises(TypeError, match="pin dense_dequant"):
        q_proj(torch.zeros(1, 64))
    x = ids(8)
    fused = engine(x).float()
    for m in engine.module.modules():
        if isinstance(m, QuantizedLinear):
            m.set_impl("dense_dequant")
    dense = engine(x).float()
    # one bf16 rounding of some matmul outputs apart, through 2 layers
    assert ((fused - dense).norm() / dense.norm()).item() < 2e-2


def test_set_params_quantizes_anew(tiny):
    conf = quant_config(8)
    engine = deepspeed_tpu_torch.init_inference(
        LlamaForCausalLM(LlamaConfig.tiny(dtype=torch.float32)), config=conf,
        params=tiny[2], device="cpu")
    other = {k: v * 0.5 for k, v in params_from_flax(tiny[2]).items()}
    engine.set_params(other)
    fresh = deepspeed_tpu_torch.init_inference(
        LlamaForCausalLM(LlamaConfig.tiny(dtype=torch.float32)), config=conf,
        params=other, device="cpu")
    assert torch.equal(engine(ids(9)), fresh(ids(9)))
    with pytest.raises(ValueError, match="name nothing"):
        engine.set_params({"nope.weight": torch.zeros(1)})


# -- what the port does not serve yet, and the reference's own fault ---------

def test_unported_settings_raise(tiny, tmp_path):
    model = port_model(tiny)
    # tensor-parallel and replicated serving are ported (tests/
    # test_torch_tensor_parallel.py); in a world of one process they clamp
    # to one rank, as the JAX engine clamps its mesh to the devices it has
    for config in ({"tensor_parallel": {"tp_size": 2}}, {"mp_size": 2}, {"replica_num": 2}):
        eng = deepspeed_tpu_torch.init_inference(model, config=dict(config, dtype="fp32"),
                                                 device="cpu")
        assert eng.grid == {"dp": 1, "tp": 1}
        assert torch.equal(eng(ids(9)), model(torch.as_tensor(ids(9))))
    with pytest.raises(NotImplementedError, match="integer"):
        deepspeed_tpu_torch.init_inference(model, config={"dtype": "int8"}, device="cpu")
    # an HF directory of the Llama family serves through its converted
    # weights; another family's has no v1 forward yet
    from deepspeed_tpu_torch.checkpoint import hf
    hf.export_pretrained(model, model.config, str(tmp_path / "llama"))
    served = deepspeed_tpu_torch.init_inference(
        port_model(tiny), config={"checkpoint": str(tmp_path / "llama"), "dtype": "fp32"},
        device="cpu")
    assert torch.equal(served(ids(9)), model(torch.as_tensor(ids(9))))
    (tmp_path / "opt").mkdir()
    (tmp_path / "opt" / "config.json").write_text('{"model_type": "opt"}')
    with pytest.raises(NotImplementedError, match="A7 part 2"):
        deepspeed_tpu_torch.init_inference(model, config={"checkpoint": str(tmp_path / "opt")},
                                           device="cpu")


def test_native_checkpoint_loads_where_jax_asserts(tiny, tmp_path):
    """Reference fault (ROADMAP §C): the JAX v1 engine calls
    ``NativeCheckpointEngine().load(path)`` without the template that load
    asserts on, so ``init_inference(checkpoint=<native tag>)`` raises. The
    port loads the tag's working weights into the model, the intent of the
    JAX code (``state.get("module", state)``)."""
    from deepspeed_tpu.runtime.checkpoint_engine.native_engine import (
        NativeCheckpointEngine as JaxNative)
    jmodel, params, np_params = tiny
    JaxNative().save({"module": params}, str(tmp_path / "jax_tag"))
    with pytest.raises(AssertionError, match="template"):
        deepspeed_tpu.init_inference(jmodel, config={"checkpoint": str(tmp_path / "jax_tag")})

    trainer, *_ = deepspeed_tpu_torch.initialize(
        model=port_model(tiny).requires_grad_(True), device="cpu",
        config={"train_batch_size": 2, "bf16": {"enabled": True},
                "optimizer": {"type": "AdamW", "params": {"lr": 1e-2}}})
    batch = {"input_ids": ids(10), "labels": ids(10)}
    trainer.backward(trainer(batch))
    trainer.step()
    tag = trainer.save_checkpoint(str(tmp_path / "port"))
    conf = dict(quant_config(8, "bf16"), checkpoint=tag)
    from_tag = deepspeed_tpu_torch.init_inference(
        LlamaForCausalLM(LlamaConfig.tiny(dtype=torch.float32)), config=conf, device="cpu")
    live = {n: p.detach().clone() for n, p in trainer.module.named_parameters()}
    from_live = deepspeed_tpu_torch.init_inference(
        LlamaForCausalLM(LlamaConfig.tiny(dtype=torch.float32)), config=quant_config(8, "bf16"),
        params=live, device="cpu")
    assert torch.equal(from_tag(ids(11)), from_live(ids(11)))


@pytest.mark.parametrize("bits", [8, 4])
def test_dequantize_param_tree_matches_jax(tiny, bits):
    """The dense weights of a quantized model, in ``nn.Linear``'s layout,
    are the JAX tree's dequantized leaves transposed (Dense kernels) or as
    they are (``lm_head``); unquantized leaves pass through."""
    from deepspeed_tpu.inference.quantization import dequantize_param_tree as jax_deq
    from deepspeed_tpu_torch.inference.quantization import dequantize_param_tree
    jmodel, params, np_params = tiny
    conf = quant_config(bits)
    jtree = jax_deq(deepspeed_tpu.init_inference(jmodel, config=conf, params=params).params,
                    jnp.float32)
    module = deepspeed_tpu_torch.init_inference(
        LlamaForCausalLM(LlamaConfig.tiny(dtype=torch.float32)), config=conf,
        params=np_params, device="cpu").module
    dense = dequantize_param_tree(module, torch.float32)
    want = params_from_flax(jax.tree.map(np.asarray, jtree))
    assert dense.keys() == want.keys()
    for k, v in want.items():
        assert torch.equal(dense[k], v), k
