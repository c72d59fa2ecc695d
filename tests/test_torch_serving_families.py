"""The port's OPT and Falcon/Phi serving families against the JAX package
and transformers, on the CPU.

- The models (``models/opt.py``, ``models/parallel_block.py``): the same
  flax weights carried through ``params_from_flax``; logits and loss of the
  training forward to 2e-5.
- The ragged forwards (``model_implementations/{opt,parallel_block}.py``)
  behind ``InferenceEngineV2`` against the JAX engine on the same weights:
  ``put`` logits for prefill, decode and a mixed batch to 2e-5, and
  ``SplitFuseScheduler`` greedy streams identical, as
  ``tests/test_torch_serving.py`` holds Llama.
- ``build_hf_engine`` on HF directories (``tests/test_inference_v2_mixtral.py``:
  Mixtral prefill, decode against HF greedy generation and a ragged batch,
  Qwen2 biases, the Mistral window, Falcon, Phi and OPT with a decode leg,
  and the unknown-family rejection; beside them Llama, Falcon's
  interleaved qkv with biases and Qwen v1): next-token logits against
  transformers at the JAX tests' 2e-2 and against the JAX package's
  ``build_hf_engine`` on the same directory to 2e-5.

Every engine here runs fp32 weights, activations and KV pages (the JAX
tests' default bf16 pages would add a rounding that either package may place
on the other side of a tie); the two packages differ only in matmul and
reduction order, which moves logits of magnitude ~1 by ~1e-6. Greedy tokens
must be identical.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

transformers = pytest.importorskip("transformers")

from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JaxEngine  # noqa: E402
from deepspeed_tpu.inference.v2.engine_factory import build_hf_engine as jax_build  # noqa: E402
from deepspeed_tpu.inference.v2.scheduler import SplitFuseScheduler as JaxScheduler  # noqa: E402
from deepspeed_tpu.models import falcon as jax_falcon  # noqa: E402
from deepspeed_tpu.models import phi as jax_phi  # noqa: E402
from deepspeed_tpu.models.opt import OPTConfig as JaxOPTConfig  # noqa: E402
from deepspeed_tpu.models.opt import OPTForCausalLM as JaxOPT  # noqa: E402
from deepspeed_tpu.models.parallel_block import ParallelBlockForCausalLM as JaxBlock  # noqa: E402
from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2, SplitFuseScheduler,  # noqa: E402
                                              build_engine, build_hf_engine)
from deepspeed_tpu_torch.inference.v2.engine_factory import (resolve_forward_fn,  # noqa: E402
                                                             resolve_verify_fn)
from deepspeed_tpu_torch.inference.v2.model_implementations import opt as opt_impl  # noqa: E402
from deepspeed_tpu_torch.inference.v2.model_implementations import (  # noqa: E402
    parallel_block as pb_impl)
from deepspeed_tpu_torch.models import falcon, phi  # noqa: E402
from deepspeed_tpu_torch.models import opt as port_opt  # noqa: E402
from deepspeed_tpu_torch.models import parallel_block as port_pb  # noqa: E402

ATOL = 2e-5
F32 = dict(dtype=jnp.float32, remat=False)


def _jax_params(jmodel, vocab):
    ids = np.random.default_rng(0).integers(0, vocab, (1, 8)).astype(np.int32)
    params = jmodel.init(jax.random.PRNGKey(0), {"input_ids": ids})["params"]
    return params, jax.tree.map(np.asarray, params)


FAMILIES = {
    "opt": lambda: (JaxOPT(JaxOPTConfig.tiny(scan_layers=True, **F32)),
                    port_opt.OPTForCausalLM, port_opt.OPTConfig.tiny(dtype=torch.float32),
                    port_opt.params_from_flax),
    "falcon": lambda: (JaxBlock(jax_falcon.tiny_falcon_config(**F32)),
                       port_pb.ParallelBlockForCausalLM,
                       falcon.tiny_falcon_config(dtype=torch.float32),
                       port_pb.params_from_flax),
    "falcon_mha_bias_tied": lambda: (
        JaxBlock(jax_falcon.tiny_falcon_config(num_key_value_heads=4, use_bias=True,
                                               tie_lm_head=True, **F32)),
        port_pb.ParallelBlockForCausalLM,
        falcon.tiny_falcon_config(num_key_value_heads=4, use_bias=True, tie_lm_head=True,
                                  dtype=torch.float32),
        port_pb.params_from_flax),
    "phi": lambda: (JaxBlock(jax_phi.tiny_phi_config(**F32)),
                    port_pb.ParallelBlockForCausalLM, phi.tiny_phi_config(dtype=torch.float32),
                    port_pb.params_from_flax),
}


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def family(request):
    jmodel, cls, cfg, convert = FAMILIES[request.param]()
    params, np_params = _jax_params(jmodel, cfg.vocab_size)
    model = cls(dataclasses.replace(cfg, remat=False))
    model.load_state_dict(convert(np_params))
    return request.param, jmodel, params, model.eval().requires_grad_(False)


def test_params_from_flax_covers_the_module(family):
    _, _, params, model = family
    convert = (port_opt if isinstance(model, port_opt.OPTForCausalLM) else port_pb)
    assert set(convert.params_from_flax(jax.tree.map(np.asarray, params))) == \
        set(model.state_dict())


def test_training_forward_matches_jax(family):
    """Logits and the next-token loss of the training forward (the biased
    Phi head takes the dense loss, the others the fused CE head)."""
    _, jmodel, params, model = family
    ids = np.random.default_rng(1).integers(0, model.config.vocab_size,
                                            (2, 12)).astype(np.int32)
    ref = np.asarray(jmodel.apply({"params": params}, {"input_ids": ids}))
    with torch.no_grad():
        ours = model(torch.from_numpy(ids)).numpy()
        loss = float(model({"input_ids": torch.from_numpy(ids),
                            "labels": torch.from_numpy(ids)}))
    np.testing.assert_allclose(ours, ref, atol=ATOL, rtol=0)
    ref_loss = float(jmodel.apply({"params": params}, {"input_ids": ids, "labels": ids}))
    assert abs(loss - ref_loss) <= ATOL


def engine_config(max_seqs=8, budget=64, blocks=32):
    return {"state_manager": {"max_ragged_sequence_count": max_seqs,
                              "max_ragged_batch_size": budget,
                              "max_context": 128, "num_kv_blocks": blocks},
            "kv_cache": {"block_size": 8, "cache_dtype": "fp32"}}


def engines(family, **kw):
    _, jmodel, params, model = family
    ecfg = engine_config(**kw)
    return JaxEngine(jmodel, params, config=ecfg), InferenceEngineV2(model, ecfg, device="cpu")


def put_both(pair, uids, toks):
    ref, ours = pair[0].put(uids, toks), pair[1].put(uids, toks)
    np.testing.assert_allclose(ours, ref, atol=ATOL, rtol=0)
    assert (ours.argmax(-1) == ref.argmax(-1)).all()
    return ours


def test_ragged_prefill_decode_and_mixed_batch_match_jax(family):
    name, _, _, model = family
    pair = engines(family)
    assert pair[1].attention_impl == "cuda_paged"
    assert resolve_forward_fn(model) is (opt_impl.ragged_forward if name == "opt"
                                         else pb_impl.ragged_forward)
    V = model.config.vocab_size
    rng = np.random.default_rng(2)
    a = rng.integers(0, V, 9).astype(np.int32)
    b = rng.integers(0, V, 17).astype(np.int32)
    out = put_both(pair, [10, 11], [a, b])
    c = rng.integers(0, V, 5).astype(np.int32)
    nxt = [np.asarray([np.argmax(r)], np.int32) for r in out]
    out = put_both(pair, [10, 11, 12], nxt + [c])    # decode mixed with a prefill
    for _ in range(3):
        out = put_both(pair, [10, 11, 12], [np.asarray([np.argmax(r)], np.int32)
                                            for r in out])


def _serve(sched, prompts):
    for uid, p in prompts.items():
        sched.submit(uid, p, max_new_tokens=8)
    return {u: t.tolist() for u, t in sched.run_to_completion().items()}


def test_splitfuse_greedy_streams_identical_to_jax(family):
    _, _, _, model = family
    jax_engine, engine = engines(family, max_seqs=4, budget=16, blocks=64)
    rng = np.random.default_rng(6)
    prompts = {uid: rng.integers(0, model.config.vocab_size, L).astype(np.int32)
               for uid, L in enumerate([5, 23, 40, 9, 31, 60])}
    ref = _serve(JaxScheduler(jax_engine, token_budget=16), prompts)
    ours = _serve(SplitFuseScheduler(engine, token_budget=16), prompts)
    assert ours == ref
    assert engine.free_blocks == jax_engine.free_blocks == 64


def test_no_verify_forward_so_speculation_is_refused(family):
    """As in the JAX package, these families have no k-token verify
    forward: speculation on their engine raises."""
    _, jmodel, params, model = family
    assert resolve_verify_fn(model) is None
    spec = dict(engine_config(), speculative={"enabled": True, "max_draft_tokens": 4})
    with pytest.raises(ValueError, match="verify forward"):
        build_engine(model, spec, device="cpu")
    with pytest.raises(ValueError, match="verify forward"):
        JaxEngine(jmodel, params, config=spec)


# -- build_hf_engine on HF directories (test_inference_v2_mixtral.py) ---------

HF_ENGINE = {"state_manager": {"max_ragged_sequence_count": 4, "max_ragged_batch_size": 64,
                               "max_context": 128},
             "kv_cache": {"cache_dtype": "fp32"}}


def hf_dir(tmp_path, name, cfg, cls, seed):
    torch.manual_seed(seed)
    model = cls(cfg).eval()
    d = str(tmp_path / name)
    model.save_pretrained(d, safe_serialization=True)
    return model, d


def hf_next_logits(model, ids):
    with torch.no_grad():
        return model(torch.from_numpy(np.asarray(ids))).logits[:, -1].float().numpy()


def both_engines(d):
    return (build_hf_engine(d, HF_ENGINE, dtype=torch.float32, device="cpu"),
            jax_build(d, HF_ENGINE, dtype=np.float32))


def check_put(pair, hf_model, uids, prompts, contexts=None, atol=2e-2):
    """One ``put`` through both engines: logits against transformers'
    next-token logits of each row's whole context, and against the JAX
    engine's."""
    ours, theirs = pair[0].put(uids, prompts), pair[1].put(uids, prompts)
    np.testing.assert_allclose(ours, theirs, atol=ATOL, rtol=0)
    for row, ctx in zip(ours, contexts or prompts):
        np.testing.assert_allclose(row, hf_next_logits(hf_model, np.asarray(ctx)[None])[0],
                                   atol=atol, rtol=atol)
    return ours


def tiny_mixtral(tmp_path, seed=0):
    cfg = transformers.MixtralConfig(
        vocab_size=128, hidden_size=32, intermediate_size=64,
        num_hidden_layers=2, num_attention_heads=2, num_key_value_heads=1,
        num_local_experts=4, num_experts_per_tok=2,
        max_position_embeddings=128, tie_word_embeddings=False)
    return hf_dir(tmp_path, "mixtral", cfg, transformers.MixtralForCausalLM, seed)


def test_build_hf_engine_mixtral_prefill_parity(tmp_path):
    hf, d = tiny_mixtral(tmp_path)
    prompt = np.random.default_rng(0).integers(0, 128, size=16).astype(np.int32)
    check_put(both_engines(d), hf, [7], [prompt])


def test_mixtral_decode_matches_hf_generation(tmp_path):
    """Greedy decode through the ragged engine == HF greedy continuation."""
    hf, d = tiny_mixtral(tmp_path, seed=1)
    pair = both_engines(d)
    prompt = np.random.default_rng(1).integers(0, 128, size=8).astype(np.int32)
    ctx = list(prompt)
    logits = check_put(pair, hf, [1], [prompt])
    for _ in range(6):
        nxt = int(np.argmax(logits[0]))
        ctx.append(nxt)
        logits = check_put(pair, hf, [1], [np.asarray([nxt], np.int32)], [ctx])
    with torch.no_grad():
        theirs = hf.generate(torch.from_numpy(prompt[None]).long(), max_new_tokens=6,
                             do_sample=False)[0, 8:].tolist()
    assert ctx[8:] == theirs


def test_mixtral_multi_sequence_ragged_batch(tmp_path):
    hf, d = tiny_mixtral(tmp_path, seed=2)
    pair = both_engines(d)
    rng = np.random.default_rng(2)
    p1 = rng.integers(0, 128, size=12).astype(np.int32)
    p2 = rng.integers(0, 128, size=5).astype(np.int32)
    check_put(pair, hf, [11, 22], [p1, p2])
    for e in pair:
        e.flush(11)
        e.flush(22)


def test_build_hf_engine_rejects_unknown_family(tmp_path):
    cfg = transformers.GPT2Config(vocab_size=64, n_positions=16, n_embd=16,
                                  n_layer=1, n_head=1)
    _, d = hf_dir(tmp_path, "gpt2", cfg, transformers.GPT2LMHeadModel, 3)
    with pytest.raises(ValueError, match="ragged engine supports"):
        build_hf_engine(d, device="cpu")
    with pytest.raises(ValueError, match="ragged engine supports"):
        jax_build(d)


def test_qwen2_bias_through_v2_engine(tmp_path):
    cfg = transformers.Qwen2Config(
        vocab_size=128, hidden_size=32, intermediate_size=64,
        num_hidden_layers=2, num_attention_heads=2, num_key_value_heads=1,
        max_position_embeddings=128, tie_word_embeddings=False)
    hf, d = hf_dir(tmp_path, "qwen2", cfg, transformers.Qwen2ForCausalLM, 4)
    prompt = np.random.default_rng(4).integers(0, 128, size=10).astype(np.int32)
    check_put(both_engines(d), hf, [1], [prompt])


def test_mistral_sliding_window_through_v2_engine(tmp_path):
    cfg = transformers.MistralConfig(
        vocab_size=128, hidden_size=32, intermediate_size=64,
        num_hidden_layers=2, num_attention_heads=2, num_key_value_heads=1,
        max_position_embeddings=128, sliding_window=8,
        tie_word_embeddings=False)
    hf, d = hf_dir(tmp_path, "mistral", cfg, transformers.MistralForCausalLM, 5)
    # prompt longer than the window so windowing actually matters
    prompt = np.random.default_rng(5).integers(0, 128, size=24).astype(np.int32)
    pair = both_engines(d)
    assert pair[0]._model.config.sliding_window == 8
    logits = check_put(pair, hf, [1], [prompt])
    nxt = int(np.argmax(logits[0]))
    check_put(pair, hf, [1], [np.asarray([nxt], np.int32)], [list(prompt) + [nxt]])


def _prefill_and_decode(d, hf, prompt):
    pair = both_engines(d)
    logits = check_put(pair, hf, [1], [prompt])
    # decode continues greedily in agreement
    nxt = int(np.argmax(logits[0]))
    check_put(pair, hf, [1], [np.asarray([nxt], np.int32)], [list(prompt) + [nxt]])
    return pair


def test_falcon_through_v2_engine(tmp_path):
    cfg = transformers.FalconConfig(
        vocab_size=128, hidden_size=64, num_hidden_layers=2,
        num_attention_heads=4, multi_query=True,
        new_decoder_architecture=False, parallel_attn=True, bias=False,
        alibi=False, max_position_embeddings=128, tie_word_embeddings=False)
    hf, d = hf_dir(tmp_path, "falcon", cfg, transformers.FalconForCausalLM, 6)
    prompt = np.random.default_rng(6).integers(0, 128, size=11).astype(np.int32)
    pair = _prefill_and_decode(d, hf, prompt)
    assert pair[0]._model.config.num_key_value_heads == 1
    assert not pair[0].verify_supported


def test_phi_through_v2_engine(tmp_path):
    cfg = transformers.PhiConfig(
        vocab_size=128, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=4,
        partial_rotary_factor=0.5, max_position_embeddings=128,
        tie_word_embeddings=False)
    hf, d = hf_dir(tmp_path, "phi", cfg, transformers.PhiForCausalLM, 7)
    prompt = np.random.default_rng(7).integers(0, 128, size=9).astype(np.int32)
    _prefill_and_decode(d, hf, prompt)


@pytest.mark.parametrize("family", ["llama", "falcon_mha_bias"])
def test_llama_and_falcon_mha_through_v2_engine(tmp_path, family):
    """The families test_inference_v2_mixtral.py leaves to the model tests:
    plain Llama (GQA), and Falcon's per-head-interleaved fused qkv with
    biases (multi_query=False)."""
    if family == "llama":
        cfg = transformers.LlamaConfig(
            vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128,
            tie_word_embeddings=False)
        cls = transformers.LlamaForCausalLM
    else:
        cfg = transformers.FalconConfig(
            vocab_size=128, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
            multi_query=False, new_decoder_architecture=False, parallel_attn=True,
            bias=True, alibi=False, max_position_embeddings=128, tie_word_embeddings=False)
        cls = transformers.FalconForCausalLM
    hf, d = hf_dir(tmp_path, family, cfg, cls, 9)
    prompt = np.random.default_rng(9).integers(0, 128, size=13).astype(np.int32)
    _prefill_and_decode(d, hf, prompt)


def test_qwen_v1_through_v2_engine(tmp_path):
    """Qwen v1 (remote code, no transformers class): build_hf_engine's
    next-token logits against the JAX tests' hand-rolled reference of the
    architecture and against the JAX engine."""
    from test_hf_qwen_internlm import _qwen_ckpt, _qwen_reference, _write_ckpt
    rng = np.random.default_rng(10)
    sd, cfg = _qwen_ckpt(rng, H=2)          # heads of 16: the paged kernel's least
    d = _write_ckpt(tmp_path, sd, cfg)
    pair = both_engines(d)
    prompt = rng.integers(0, cfg["vocab_size"], size=11).astype(np.int32)
    ours = pair[0].put([1], [prompt])
    np.testing.assert_allclose(ours, pair[1].put([1], [prompt]), atol=ATOL, rtol=0)
    np.testing.assert_allclose(ours[0], _qwen_reference(sd, cfg, prompt[None])[0, -1],
                               atol=2e-2, rtol=2e-2)


def test_opt_through_v2_engine(tmp_path):
    """OPT completes the reference's v2 family set (engine_factory.py:99);
    the decode leg keeps the +2 position offset through the cache."""
    cfg = transformers.OPTConfig(
        vocab_size=128, hidden_size=64, ffn_dim=128, num_hidden_layers=2,
        num_attention_heads=4, max_position_embeddings=128,
        do_layer_norm_before=True, word_embed_proj_dim=64)
    hf, d = hf_dir(tmp_path, "opt", cfg, transformers.OPTForCausalLM, 8)
    prompt = np.random.default_rng(8).integers(0, 128, size=12).astype(np.int32)
    _prefill_and_decode(d, hf, prompt)


def test_opt_positions_past_the_table_clamp(tmp_path):
    """Padded token slots of a row near the end of the context read
    positions past the learned table; they clamp (the JAX gather's rule)
    instead of indexing out of range, and the real rows are unchanged."""
    cfg = dataclasses.replace(port_opt.OPTConfig.tiny(dtype=torch.float32),
                              max_position_embeddings=16)
    model = port_opt.OPTForCausalLM.from_seed(cfg, seed=0, device="cpu", std=0.1)
    ecfg = {"state_manager": {"max_ragged_sequence_count": 2, "max_ragged_batch_size": 32,
                              "max_context": 16, "num_kv_blocks": 8},
            "kv_cache": {"block_size": 8, "cache_dtype": "fp32"}}
    engine = build_engine(model, ecfg, device="cpu")
    rng = np.random.default_rng(9)
    a, b = rng.integers(0, 512, 15).astype(np.int32), rng.integers(0, 512, 12).astype(np.int32)
    engine.put([1], [a])
    both = engine.put([1, 2], [a[:1], b])       # row 1 at position 15, padded to 16
    alone = build_engine(model, ecfg, device="cpu")
    alone.put([1], [a])
    np.testing.assert_allclose(both[0], alone.put([1], [a[:1]])[0], atol=1e-5, rtol=0)
    ids = np.concatenate([a, a[:1]])[None]
    with torch.no_grad():
        full = model(torch.from_numpy(ids))[0, -1].numpy()
    np.testing.assert_allclose(both[0], full, atol=1e-4, rtol=0)
