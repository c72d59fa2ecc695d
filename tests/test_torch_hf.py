"""The port's HuggingFace checkpoint interop (``deepspeed_tpu_torch/
checkpoint/hf.py``) against transformers and the JAX package, on the CPU.

Mirrors ``tests/test_hf_interop.py`` (every llama, qwen2, opt, mixtral,
falcon and phi case, the explicit ``head_dim``, the Mistral window export,
the export round trip, ``save_16bit_model``, ``load_hf_weights``, the
inference engine from an HF directory, the rejected Falcon and the
trainable Falcon/Phi) and ``tests/test_hf_qwen_internlm.py`` (all six;
the engine cases with heads of 16, the paged kernel's least width, where
the JAX tests' are 8), with tiny random checkpoints written into ``tmp_path`` by
``save_pretrained``. Each logits case holds the port against transformers
at the JAX tests' tolerance (``atol 2e-3``, ``rtol 1e-3``; MoE ``2e-2``) and
against the JAX package's ``load_pretrained`` on the same directory, both in
fp32, to ``2e-5`` (the two differ only in matmul and reduction order, which
moves logits of magnitude ~1 by ~1e-6).

The IO layer: the port reads what ``safetensors`` writes bit for bit in
every dtype it takes, and a sharded directory; ``safetensors`` reads what
the port writes; each ``config.json`` reader matches
``transformers.AutoConfig`` on the same file and on one with the optional
keys removed. Port modules never import jax, deepspeed_tpu, transformers or
safetensors (a subprocess with the four made unimportable imports them all).
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

transformers = pytest.importorskip("transformers")
safetensors_torch = pytest.importorskip("safetensors.torch")

from deepspeed_tpu.checkpoint import hf as jax_hf  # noqa: E402
import deepspeed_tpu_torch  # noqa: E402
from deepspeed_tpu_torch.checkpoint import hf  # noqa: E402

ATOL_JAX = 2e-5


def hf_logits(model, ids):
    with torch.no_grad():
        return model(torch.from_numpy(ids)).logits.float().numpy()


def port_logits(model, ids):
    model.eval()
    with torch.no_grad():
        return model(torch.from_numpy(ids)).float().numpy()


def jax_logits(model_dir, ids, **kw):
    """The JAX package's ``load_pretrained`` on ``model_dir``, run in fp32."""
    model, params = jax_hf.load_pretrained(model_dir, **kw)
    fcfg = dataclasses.replace(model.config, dtype=jnp.float32, remat=False)
    return np.asarray(type(model)(fcfg).apply({"params": params}, {"input_ids": ids}),
                      np.float32)


def assert_logits_close(a, b, atol=2e-3):
    np.testing.assert_allclose(a, b, atol=atol, rtol=1e-3)


def save_hf(model, cfg, tmp_path, name="ckpt", **kw):
    d = str(tmp_path / name)
    model.save_pretrained(d, safe_serialization=True, **kw)
    cfg.save_pretrained(d)
    return d


def load(d, **kw):
    return hf.load_pretrained(d, device="cpu", **kw)


def check_family(d, hf_model, ids, atol=2e-3):
    """The port's fp32 model from ``d`` against transformers and against
    the JAX package; returns the port module."""
    model = load(d)
    ours = port_logits(model, ids)
    assert_logits_close(ours, hf_logits(hf_model, ids), atol=atol)
    np.testing.assert_allclose(ours, jax_logits(d, ids), atol=ATOL_JAX, rtol=0)
    return model


# -- test_hf_interop.py ------------------------------------------------------

@pytest.mark.parametrize("kv_heads", [4, 2])
def test_llama_roundtrip_logits(tmp_path, kv_heads):
    cfg = transformers.LlamaConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=kv_heads, max_position_embeddings=64,
        tie_word_embeddings=False)
    torch.manual_seed(0)
    hf_model = transformers.LlamaForCausalLM(cfg).eval()
    d = save_hf(hf_model, cfg, tmp_path)
    ids = np.random.default_rng(0).integers(0, 256, size=(2, 16)).astype(np.int32)
    model = check_family(d, hf_model, ids)
    assert model.config.num_key_value_heads == kv_heads


def test_llama_scan_and_unscanned_agree(tmp_path):
    """The port keeps a module per layer; the JAX package's scanned and
    unscanned trees of the same directory both match it."""
    cfg = transformers.LlamaConfig(
        vocab_size=128, hidden_size=32, intermediate_size=64,
        num_hidden_layers=3, num_attention_heads=2, num_key_value_heads=2,
        max_position_embeddings=32, tie_word_embeddings=False)
    torch.manual_seed(1)
    hf_model = transformers.LlamaForCausalLM(cfg).eval()
    d = save_hf(hf_model, cfg, tmp_path)
    ids = np.arange(16, dtype=np.int32).reshape(1, 16) % 128
    ours = port_logits(load(d), ids)
    for scan in (True, False):
        np.testing.assert_allclose(ours, jax_logits(d, ids, scan_layers=scan),
                                   atol=ATOL_JAX, rtol=0)


def test_qwen2_bias_logits(tmp_path):
    cfg = transformers.Qwen2Config(
        vocab_size=128, hidden_size=32, intermediate_size=64,
        num_hidden_layers=2, num_attention_heads=2, num_key_value_heads=1,
        max_position_embeddings=32, tie_word_embeddings=False)
    torch.manual_seed(2)
    hf_model = transformers.Qwen2ForCausalLM(cfg).eval()
    d = save_hf(hf_model, cfg, tmp_path)
    ids = np.random.default_rng(2).integers(0, 128, size=(1, 12)).astype(np.int32)
    model = check_family(d, hf_model, ids)
    assert model.config.attention_bias


def test_opt_logits(tmp_path):
    cfg = transformers.OPTConfig(vocab_size=128, hidden_size=32, ffn_dim=64,
                                 num_hidden_layers=2, num_attention_heads=2,
                                 max_position_embeddings=32,
                                 do_layer_norm_before=True,
                                 word_embed_proj_dim=32)
    torch.manual_seed(4)
    hf_model = transformers.OPTForCausalLM(cfg).eval()
    d = save_hf(hf_model, cfg, tmp_path)
    ids = np.random.default_rng(4).integers(0, 128, size=(2, 10)).astype(np.int32)
    check_family(d, hf_model, ids)


def test_mixtral_logits(tmp_path):
    cfg = transformers.MixtralConfig(
        vocab_size=128, hidden_size=32, intermediate_size=64,
        num_hidden_layers=2, num_attention_heads=2, num_key_value_heads=1,
        num_local_experts=4, num_experts_per_tok=2,
        max_position_embeddings=32, tie_word_embeddings=False)
    torch.manual_seed(5)
    hf_model = transformers.MixtralForCausalLM(cfg).eval()
    d = save_hf(hf_model, cfg, tmp_path)
    ids = np.random.default_rng(5).integers(0, 128, size=(1, 8)).astype(np.int32)
    # MoE top-k routing can tie-break differently; compare with a looser tol
    check_family(d, hf_model, ids, atol=2e-2)


def test_export_roundtrip_via_transformers(tmp_path):
    """The port's module -> export_pretrained -> transformers
    from_pretrained -> the same logits (the save_16bit_model direction)."""
    cfg = transformers.LlamaConfig(
        vocab_size=128, hidden_size=32, intermediate_size=64,
        num_hidden_layers=2, num_attention_heads=2, num_key_value_heads=2,
        max_position_embeddings=32, tie_word_embeddings=False)
    torch.manual_seed(6)
    hf_model = transformers.LlamaForCausalLM(cfg).eval()
    d = save_hf(hf_model, cfg, tmp_path)
    model = load(d)
    out = str(tmp_path / "export")
    hf.export_pretrained(model, model.config, out)
    hf2 = transformers.AutoModelForCausalLM.from_pretrained(out).eval()
    ids = np.random.default_rng(6).integers(0, 128, size=(1, 8)).astype(np.int32)
    assert_logits_close(hf_logits(hf2, ids), hf_logits(hf_model, ids), atol=1e-5)
    # the tensors themselves round-trip exactly
    a = safetensors_torch.load_file(os.path.join(d, "model.safetensors"))
    b = safetensors_torch.load_file(os.path.join(out, "model.safetensors"))
    assert set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)


def llama_engine_config(**kw):
    return dict({"train_batch_size": 8, "bf16": {"enabled": True},
                 "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
                 "zero_optimization": {"stage": 2}}, **kw)


def test_engine_save_16bit_writes_hf_checkpoint(tmp_path):
    """save_16bit_model emits a real HF checkpoint for known families (bf16
    training writes fp32, as the JAX engine does), and the npz for a model
    no converter covers."""
    from deepspeed_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    torch.manual_seed(0)
    model = LlamaForCausalLM(LlamaConfig.tiny(dtype=torch.float32))
    engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=llama_engine_config(),
                                                device="cpu")
    ids = torch.zeros((8, 16), dtype=torch.long)
    loss = engine({"input_ids": ids, "labels": ids})
    engine.backward(loss)
    engine.step()
    out = str(tmp_path / "hf_out")
    path = engine.save_16bit_model(out)
    assert path.endswith("model.safetensors")
    hf_model = transformers.AutoModelForCausalLM.from_pretrained(out).eval()
    assert hf_model.config.model_type == "llama"
    st = safetensors_torch.load_file(path)
    assert {t.dtype for t in st.values()} == {torch.float32}
    masters = engine.get_model_parameters()
    assert torch.equal(st["model.norm.weight"], masters["norm.weight"])
    npz = engine.save_16bit_model(str(tmp_path / "npz"), save_filename="w.npz")
    assert npz.endswith("w.npz") and "norm.weight" in np.load(npz).files


def test_engine_load_hf_weights(tmp_path):
    """HF checkpoint -> live ZeRO-3 bf16 training engine (the
    load_module_only analog): the engine then computes the HF model's loss."""
    from deepspeed_tpu_torch.models.llama import LlamaForCausalLM
    cfg = transformers.LlamaConfig(
        vocab_size=128, hidden_size=32, intermediate_size=64,
        num_hidden_layers=2, num_attention_heads=2, num_key_value_heads=2,
        max_position_embeddings=64, tie_word_embeddings=False)
    torch.manual_seed(9)
    hf_model = transformers.LlamaForCausalLM(cfg).eval()
    d = save_hf(hf_model, cfg, tmp_path)
    template = load(d).config
    torch.manual_seed(1)
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=LlamaForCausalLM(template), device="cpu",
        config=llama_engine_config(zero_optimization={
            "stage": 3, "stage3_param_persistence_threshold": 0}))
    params = engine.load_hf_weights(d)
    masters = engine.get_model_parameters()
    assert all(torch.equal(masters[k], params[k]) for k in params)
    ids = np.random.default_rng(9).integers(0, 128, size=(8, 16)).astype(np.int64)
    loss = float(engine({"input_ids": ids, "labels": ids}).detach())
    with torch.no_grad():
        t = torch.from_numpy(ids)
        hf_loss = float(hf_model(t, labels=t).loss)
    assert abs(loss - hf_loss) < 0.05, (loss, hf_loss)


def test_inference_engine_from_hf_dir(tmp_path):
    """init_inference(checkpoint=<HF dir>) adopts and serves the converted
    model; the logits match transformers and the JAX package's tree of the
    same directory, and greedy generation runs on the KV cache."""
    cfg = transformers.LlamaConfig(
        vocab_size=128, hidden_size=32, intermediate_size=64,
        num_hidden_layers=2, num_attention_heads=2, num_key_value_heads=2,
        max_position_embeddings=64, tie_word_embeddings=False)
    torch.manual_seed(10)
    hf_model = transformers.LlamaForCausalLM(cfg).eval()
    d = save_hf(hf_model, cfg, tmp_path)
    eng = deepspeed_tpu_torch.init_inference(model=None, config={
        "checkpoint": d, "dtype": "fp32"}, device="cpu")
    assert eng.module is not None
    ids = np.random.default_rng(10).integers(0, 128, size=(1, 8)).astype(np.int32)
    ours = eng(torch.from_numpy(ids)).float().numpy()
    assert_logits_close(ours, hf_logits(hf_model, ids))
    np.testing.assert_allclose(ours, jax_logits(d, ids), atol=ATOL_JAX, rtol=0)
    with torch.no_grad():
        theirs = hf_model.generate(torch.from_numpy(ids).long(), max_new_tokens=4,
                                   do_sample=False)[:, 8:]
    assert eng.generate(ids, max_new_tokens=4).tolist() == theirs.tolist()


def test_explicit_head_dim_logits(tmp_path):
    """Mistral-Nemo-style checkpoints: head_dim != hidden_size // heads."""
    cfg = transformers.MistralConfig(
        vocab_size=128, hidden_size=48, intermediate_size=64,
        num_hidden_layers=2, num_attention_heads=2, num_key_value_heads=1,
        head_dim=32, max_position_embeddings=64, sliding_window=None,
        tie_word_embeddings=False)
    torch.manual_seed(11)
    hf_model = transformers.MistralForCausalLM(cfg).eval()
    d = save_hf(hf_model, cfg, tmp_path)
    ids = np.random.default_rng(11).integers(0, 128, size=(1, 10)).astype(np.int32)
    model = check_family(d, hf_model, ids)
    assert model.config.head_dim == 32
    out = str(tmp_path / "export")
    hf.export_pretrained(model, model.config, out)
    with open(os.path.join(out, "config.json")) as f:
        assert json.load(f)["head_dim"] == 32
    np.testing.assert_array_equal(port_logits(load(out), ids), port_logits(model, ids))


def test_mistral_export_keeps_window(tmp_path):
    """Export writes model_type mistral + sliding_window when windowed, and
    transformers serves the export with the window."""
    from deepspeed_tpu_torch.models.llama import LlamaForCausalLM
    from deepspeed_tpu_torch.models.mistral import tiny_mistral_config
    cfg = tiny_mistral_config(dtype=torch.float32)
    assert cfg.sliding_window
    model = LlamaForCausalLM.from_seed(cfg, seed=0, device="cpu", std=0.1)
    out = str(tmp_path / "mistral_out")
    hf.export_pretrained(model, cfg, out)
    with open(os.path.join(out, "config.json")) as f:
        hf_cfg = json.load(f)
    assert hf_cfg["model_type"] == "mistral"
    assert hf_cfg["sliding_window"] == cfg.sliding_window
    ids = np.random.default_rng(12).integers(0, 512, size=(1, 40)).astype(np.int32)
    hf_model = transformers.AutoModelForCausalLM.from_pretrained(out).eval()
    assert_logits_close(port_logits(model, ids), hf_logits(hf_model, ids))


def falcon_config(**kw):
    return transformers.FalconConfig(**{**dict(
        vocab_size=128, hidden_size=64, num_hidden_layers=2,
        num_attention_heads=4, multi_query=True,
        new_decoder_architecture=False, parallel_attn=True, bias=False,
        alibi=False, max_position_embeddings=64, tie_word_embeddings=False), **kw})


def test_falcon_logits(tmp_path):
    cfg = falcon_config()
    torch.manual_seed(12)
    hf_model = transformers.FalconForCausalLM(cfg).eval()
    d = save_hf(hf_model, cfg, tmp_path)
    ids = np.random.default_rng(12).integers(0, 128, size=(2, 10)).astype(np.int32)
    model = check_family(d, hf_model, ids)
    assert model.config.num_key_value_heads == 1  # MQA


def test_phi_logits(tmp_path):
    cfg = transformers.PhiConfig(
        vocab_size=128, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=4,
        partial_rotary_factor=0.5, max_position_embeddings=64,
        tie_word_embeddings=False)
    torch.manual_seed(13)
    hf_model = transformers.PhiForCausalLM(cfg).eval()
    d = save_hf(hf_model, cfg, tmp_path)
    ids = np.random.default_rng(13).integers(0, 128, size=(2, 10)).astype(np.int32)
    model = check_family(d, hf_model, ids)
    assert model.config.rotary_dim == 8  # 0.5 * head_dim 16


def test_falcon_phi_trainable():
    """The new families train through the port's engine (loss decreases)."""
    from deepspeed_tpu_torch.models.falcon import tiny_falcon_config
    from deepspeed_tpu_torch.models.parallel_block import ParallelBlockForCausalLM
    from deepspeed_tpu_torch.models.phi import tiny_phi_config
    for cfg in (tiny_falcon_config(), tiny_phi_config()):
        torch.manual_seed(0)
        model = ParallelBlockForCausalLM(cfg)
        ids = (np.arange(8 * 16) % cfg.vocab_size).astype(np.int64).reshape(8, 16)
        batch = {"input_ids": ids, "labels": ids}
        engine, *_ = deepspeed_tpu_torch.initialize(
            model=model, device="cpu",
            config={"train_batch_size": 8, "bf16": {"enabled": True},
                    "optimizer": {"type": "AdamW", "params": {"lr": 3e-3}},
                    "zero_optimization": {"stage": 2}})
        losses = []
        for _ in range(5):
            loss = engine(batch)
            engine.backward(loss)
            engine.step()
            losses.append(float(loss))
        assert losses[-1] < losses[0], (cfg, losses)


def test_falcon_mha_interleaved_and_bias_logits(tmp_path):
    """multi_query=False (per-head interleaved fused QKV) + bias=True; the
    export writes the interleaved layout back bit for bit."""
    cfg = falcon_config(multi_query=False, bias=True)
    torch.manual_seed(14)
    hf_model = transformers.FalconForCausalLM(cfg).eval()
    d = save_hf(hf_model, cfg, tmp_path)
    ids = np.random.default_rng(14).integers(0, 128, size=(2, 10)).astype(np.int32)
    model = check_family(d, hf_model, ids)
    assert model.config.num_key_value_heads == 4 and model.config.use_bias
    out = str(tmp_path / "export")
    hf.export_pretrained(model, model.config, out)
    a = safetensors_torch.load_file(os.path.join(d, "model.safetensors"))
    b = safetensors_torch.load_file(os.path.join(out, "model.safetensors"))
    assert all(torch.equal(a[k], b[k]) for k in b)


def test_falcon_sequential_residual_rejected(tmp_path):
    """The JAX guards raise the same UnsupportedModelError with the same
    cause: parallel_attn=False, alibi, new_decoder_architecture."""
    for i, (kw, cause) in enumerate((
            (dict(parallel_attn=False, bias=True), "parallel_attn"),
            (dict(alibi=True), "alibi"),
            (dict(new_decoder_architecture=True), "new_decoder_architecture"))):
        cfg = transformers.FalconConfig(**{**dict(
            vocab_size=64, hidden_size=32, num_hidden_layers=1, num_attention_heads=2,
            multi_query=True, new_decoder_architecture=False, parallel_attn=True,
            alibi=False, bias=False, max_position_embeddings=32), **kw})
        torch.manual_seed(15)
        d = save_hf(transformers.FalconForCausalLM(cfg), cfg, tmp_path, f"f{i}")
        with pytest.raises(hf.UnsupportedModelError, match=cause):
            load(d)
        with pytest.raises(jax_hf.UnsupportedModelError, match=cause):
            jax_hf.load_pretrained(d)


@pytest.mark.parametrize("kw,cause", [
    (dict(do_layer_norm_before=False), "do_layer_norm_before"),
    (dict(word_embed_proj_dim=16), "word_embed_proj_dim")], ids=["post_ln", "project"])
def test_opt_variants_rejected(tmp_path, kw, cause):
    cfg = transformers.OPTConfig(**{**dict(
        vocab_size=64, hidden_size=32, ffn_dim=64, num_hidden_layers=1,
        num_attention_heads=2, max_position_embeddings=32), **kw})
    torch.manual_seed(16)
    d = save_hf(transformers.OPTForCausalLM(cfg), cfg, tmp_path)
    with pytest.raises(hf.UnsupportedModelError, match=cause):
        load(d)
    with pytest.raises(jax_hf.UnsupportedModelError, match=cause):
        jax_hf.load_pretrained(d)


def test_unported_families_raise_naming_their_queue_item(tmp_path):
    cfg = transformers.GPT2Config(vocab_size=64, n_positions=16, n_embd=16,
                                  n_layer=1, n_head=1)
    d = save_hf(transformers.GPT2LMHeadModel(cfg), cfg, tmp_path, "gpt2")
    # gpt2 is ported: it loads (tests/test_torch_gpt2.py holds its logits)
    from deepspeed_tpu_torch.models.gpt2 import GPT2LMHeadModel
    assert isinstance(load(d), GPT2LMHeadModel)
    for mt in ("bloom", "gpt_neox", "gptj", "bert", "roberta", "distilbert"):
        (tmp_path / mt).mkdir()
        (tmp_path / mt / "config.json").write_text(json.dumps({"model_type": mt}))
        with pytest.raises(NotImplementedError, match="A12"):
            load(str(tmp_path / mt))
    (tmp_path / "t5").mkdir()
    (tmp_path / "t5" / "config.json").write_text(json.dumps({"model_type": "t5"}))
    with pytest.raises(hf.UnsupportedModelError, match="unsupported model_type"):
        load(str(tmp_path / "t5"))


# -- test_hf_qwen_internlm.py -------------------------------------------------
# Remote-code families: the oracle is the JAX tests' hand-rolled torch
# reference of each architecture.

from test_hf_qwen_internlm import (_internlm_ckpt, _internlm_reference,  # noqa: E402
                                   _qwen_ckpt, _qwen_reference, _write_ckpt)


def test_qwen_v1_exact_logits(tmp_path):
    rng = np.random.default_rng(0)
    sd, cfg = _qwen_ckpt(rng)
    d = _write_ckpt(tmp_path, sd, cfg)
    model = load(d)
    assert model.config.attention_bias and not model.config.attention_out_bias
    assert model.config.intermediate_size == 64    # ff = intermediate // 2
    ids = rng.integers(0, cfg["vocab_size"], size=(2, 12)).astype(np.int32)
    ours = port_logits(model, ids)
    np.testing.assert_allclose(ours, _qwen_reference(sd, cfg, ids), atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(ours, jax_logits(d, ids), atol=ATOL_JAX, rtol=0)


def test_qwen_v1_roundtrip_exact(tmp_path):
    rng = np.random.default_rng(1)
    sd, cfg = _qwen_ckpt(rng)
    d = _write_ckpt(tmp_path, sd, cfg)
    model = load(d)
    back = hf.qwen_from_torch(model.state_dict(), model.config)
    assert set(back) == set(sd)
    for k in sd:
        np.testing.assert_array_equal(back[k].numpy(), sd[k], err_msg=k)


def test_internlm_exact_logits(tmp_path):
    rng = np.random.default_rng(2)
    sd, cfg = _internlm_ckpt(rng)
    d = _write_ckpt(tmp_path, sd, cfg)
    model = load(d)
    assert model.config.attention_bias and model.config.attention_out_bias
    ids = rng.integers(0, cfg["vocab_size"], size=(2, 12)).astype(np.int32)
    ours = port_logits(model, ids)
    np.testing.assert_allclose(ours, _internlm_reference(sd, cfg, ids), atol=2e-4,
                               rtol=1e-3)
    np.testing.assert_allclose(ours, jax_logits(d, ids), atol=ATOL_JAX, rtol=0)


def test_internlm_export_roundtrip(tmp_path):
    """The port's module -> internlm layout -> reload -> identical logits;
    config carries model_type internlm + bias."""
    rng = np.random.default_rng(3)
    sd, cfg = _internlm_ckpt(rng)
    d = _write_ckpt(tmp_path, sd, cfg)
    model = load(d)
    out = tmp_path / "export"
    hf.export_pretrained(model, model.config, str(out))
    with open(out / "config.json") as f:
        exported = json.load(f)
    assert exported["model_type"] == "internlm" and exported["bias"] is True
    ids = rng.integers(0, cfg["vocab_size"], size=(1, 9)).astype(np.int32)
    np.testing.assert_array_equal(port_logits(load(str(out)), ids), port_logits(model, ids))


def v2_config(**kv):
    return {"state_manager": {"max_ragged_sequence_count": 2, "max_ragged_batch_size": 16,
                              "max_context": 64, "num_kv_blocks": 32},
            "kv_cache": {"block_size": 8, "cache_dtype": "fp32", **kv}}


def test_internlm_serves_through_v2(tmp_path):
    """The ragged engine applies the o_proj bias (InternLM path): last-token
    serving logits match the training forward, and the JAX engine's."""
    from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JaxEngine
    from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2
    rng = np.random.default_rng(4)
    sd, cfg = _internlm_ckpt(rng, H=2)      # heads of 16: the paged kernel's least
    d = _write_ckpt(tmp_path, sd, cfg)
    model = load(d).requires_grad_(False)
    engine = InferenceEngineV2(model, v2_config(), device="cpu")
    prompt = rng.integers(0, cfg["vocab_size"], size=12).astype(np.int32)
    served = engine.put([0], [prompt])[0]
    train = port_logits(model, prompt[None])[0, -1]
    np.testing.assert_allclose(served, train, atol=1e-3, rtol=1e-3)
    jmodel, jparams = jax_hf.load_pretrained(d)
    jfmodel = type(jmodel)(dataclasses.replace(jmodel.config, dtype=jnp.float32,
                                               remat=False))
    ref = JaxEngine(jfmodel, jparams, config=v2_config()).put([0], [prompt])[0]
    np.testing.assert_allclose(served, ref, atol=ATOL_JAX, rtol=0)


def test_internlm_through_factory(tmp_path):
    """build_hf_engine accepts the remote-code families (factory gate)."""
    from deepspeed_tpu.inference.v2.engine_factory import build_hf_engine as jax_build
    from deepspeed_tpu_torch.inference.v2 import build_hf_engine
    rng = np.random.default_rng(5)
    sd, cfg = _internlm_ckpt(rng, H=2)
    d = _write_ckpt(tmp_path, sd, cfg)
    engine = build_hf_engine(d, engine_config=v2_config(), dtype=torch.float32,
                             device="cpu")
    prompt = rng.integers(0, cfg["vocab_size"], size=7).astype(np.int32)
    logits = engine.put([0], [prompt])
    assert logits.shape == (1, cfg["vocab_size"])
    assert np.isfinite(logits).all()
    ref = jax_build(d, engine_config=v2_config(), dtype=np.float32).put([0], [prompt])
    np.testing.assert_allclose(logits, ref, atol=ATOL_JAX, rtol=0)


# -- the IO layer -------------------------------------------------------------

ST_CASES = {"F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
            "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
            "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool}


def st_tensors(seed=0):
    g = torch.Generator().manual_seed(seed)
    out = {}
    for i, (name, dt) in enumerate(ST_CASES.items()):
        shape = [(3, 5), (7,), (2, 3, 4), ()][i % 4]
        if dt.is_floating_point:
            t = torch.randn(shape, generator=g).to(dt)
        elif dt == torch.bool:
            t = torch.randint(0, 2, shape, generator=g).bool()
        else:
            info = torch.iinfo(dt)
            t = torch.randint(max(info.min, -2 ** 31), min(info.max, 2 ** 31 - 1), shape,
                              generator=g, dtype=torch.int64).to(dt)
        out[f"t.{name}"] = t
    out["empty"] = torch.zeros(0, 4)
    return out


def test_reader_takes_what_safetensors_writes_bitwise(tmp_path):
    ref = st_tensors()
    path = str(tmp_path / "a.safetensors")
    safetensors_torch.save_file(ref, path, metadata={"format": "pt"})
    got = hf.read_safetensors(path)
    assert set(got) == set(ref)
    for k, t in ref.items():
        assert got[k].dtype == t.dtype and got[k].shape == t.shape, k
        assert torch.equal(got[k], t), k
    got["t.F32"] += 1          # a copy-on-write mapping: the file is untouched
    assert torch.equal(hf.read_safetensors(path)["t.F32"], ref["t.F32"])


def test_safetensors_takes_what_the_reader_writes(tmp_path):
    ref = st_tensors(1)
    path = hf.save_safetensors(ref, str(tmp_path), "b.safetensors")
    got = safetensors_torch.load_file(path)
    assert set(got) == set(ref)
    assert all(got[k].dtype == t.dtype and torch.equal(got[k], t) for k, t in ref.items())
    with open(path, "rb") as f:
        assert (8 + int.from_bytes(f.read(8), "little")) % 8 == 0
    # a dtype given casts the floating tensors only
    path = hf.save_safetensors(ref, str(tmp_path), "c.safetensors", dtype=torch.float32)
    got = safetensors_torch.load_file(path)
    for k, t in ref.items():
        want = t.float() if t.is_floating_point() else t
        assert got[k].dtype == want.dtype and torch.equal(got[k], want), k


def test_sharded_directory_reads_whole(tmp_path):
    """A directory save_pretrained shards (model-0000x-of-0000y with its
    index) reads into one state dict equal to the model's, bf16 kept."""
    cfg = transformers.LlamaConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=3,
        num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64,
        tie_word_embeddings=False, torch_dtype="bfloat16")
    torch.manual_seed(17)
    hf_model = transformers.LlamaForCausalLM(cfg).to(torch.bfloat16).eval()
    d = save_hf(hf_model, cfg, tmp_path, max_shard_size="60KB")
    shards = [f for f in os.listdir(d) if f.endswith(".safetensors")]
    assert len(shards) > 2 and os.path.exists(os.path.join(d, "model.safetensors.index.json"))
    sd = hf.load_state_dict(d)
    want = hf_model.state_dict()
    assert set(sd) == set(want)
    assert all(sd[k].dtype == torch.bfloat16 and torch.equal(sd[k], want[k]) for k in sd)
    ids = np.random.default_rng(17).integers(0, 256, size=(1, 12)).astype(np.int32)
    model = load(d, dtype=torch.bfloat16)
    assert model.embed_tokens.weight.dtype == torch.bfloat16
    assert model.norm.weight.dtype == torch.float32
    np.testing.assert_allclose(port_logits(model, ids), hf_logits(hf_model, ids),
                               atol=0.1, rtol=0)
    os.remove(os.path.join(d, shards[0]))
    with pytest.raises(FileNotFoundError, match="index maps"):
        hf.load_state_dict(d)


def test_pytorch_bin_directory_reads(tmp_path):
    cfg = falcon_config()
    torch.manual_seed(18)
    hf_model = transformers.FalconForCausalLM(cfg).eval()
    d = save_hf(hf_model, cfg, tmp_path)
    st = save_hf(hf_model, cfg, tmp_path, "bin")
    os.remove(os.path.join(st, "model.safetensors"))
    torch.save(hf_model.state_dict(), os.path.join(st, "pytorch_model.bin"))
    ids = np.random.default_rng(18).integers(0, 128, size=(1, 6)).astype(np.int32)
    np.testing.assert_array_equal(port_logits(load(st), ids), port_logits(load(d), ids))


CONFIG_CASES = {
    "llama": (transformers.LlamaConfig, dict(
        vocab_size=96, hidden_size=48, intermediate_size=80, num_hidden_layers=3,
        num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=40,
        rms_norm_eps=1e-5, rope_theta=5e5, attention_bias=True, head_dim=16,
        tie_word_embeddings=True)),
    "mistral": (transformers.MistralConfig, dict(
        vocab_size=96, hidden_size=48, intermediate_size=80, num_hidden_layers=3,
        num_attention_heads=4, num_key_value_heads=1, max_position_embeddings=40,
        sliding_window=12, head_dim=16)),
    "qwen2": (transformers.Qwen2Config, dict(
        vocab_size=96, hidden_size=48, intermediate_size=80, num_hidden_layers=3,
        num_attention_heads=4, num_key_value_heads=2, use_sliding_window=True,
        sliding_window=12, max_window_layers=3)),
    "mixtral": (transformers.MixtralConfig, dict(
        vocab_size=96, hidden_size=48, intermediate_size=80, num_hidden_layers=3,
        num_attention_heads=4, num_key_value_heads=2, num_local_experts=6,
        num_experts_per_tok=3, rope_theta=1e4)),
    "opt": (transformers.OPTConfig, dict(
        vocab_size=96, hidden_size=48, ffn_dim=80, num_hidden_layers=3,
        num_attention_heads=4, max_position_embeddings=40, word_embed_proj_dim=48)),
    "falcon": (transformers.FalconConfig, dict(
        vocab_size=96, hidden_size=48, num_hidden_layers=3, num_attention_heads=4,
        multi_query=False, bias=True, ffn_hidden_size=100, rope_theta=5e4,
        tie_word_embeddings=False)),
    "phi": (transformers.PhiConfig, dict(
        vocab_size=96, hidden_size=48, intermediate_size=80, num_hidden_layers=3,
        num_attention_heads=4, num_key_value_heads=2, partial_rotary_factor=0.25,
        hidden_act="gelu", layer_norm_eps=1e-6, tie_word_embeddings=True)),
}


@pytest.mark.parametrize("optional", ["full", "optional_removed"])
@pytest.mark.parametrize("family", sorted(CONFIG_CASES))
def test_config_reader_matches_autoconfig(tmp_path, family, optional):
    """Each family's reader gives every key of its defaults table as
    transformers.AutoConfig reads the same config.json; with only
    model_type and the geometry kept, the defaults the file omits are
    transformers' own."""
    cls, kw = CONFIG_CASES[family]
    d = str(tmp_path / family)
    cls(**kw).save_pretrained(d)
    if optional == "optional_removed":
        path = os.path.join(d, "config.json")
        with open(path) as f:
            raw = json.load(f)
        keep = {"model_type", "vocab_size", "hidden_size", "num_hidden_layers"}
        with open(path, "w") as f:
            json.dump({k: v for k, v in raw.items() if k in keep}, f)
    auto = transformers.AutoConfig.from_pretrained(d)
    ours = hf.read_hf_config(d)
    assert ours.model_type == family
    for key in hf.HF_DEFAULTS[family]:
        assert getattr(ours, key) == getattr(auto, key), key


def test_config_readers_feed_the_jax_conversions(tmp_path):
    """The port's configs from read_hf_config equal those the JAX package
    builds from transformers.AutoConfig (llama_config_from_hf), field for
    field where both have it."""
    for family in ("llama", "mistral", "qwen2"):
        cls, kw = CONFIG_CASES[family]
        d = str(tmp_path / family)
        cls(**kw).save_pretrained(d)
        ours = hf.llama_config_from_hf(hf.read_hf_config(d))
        theirs = jax_hf.llama_config_from_hf(transformers.AutoConfig.from_pretrained(d))
        for f in dataclasses.fields(ours):
            if f.name not in ("dtype", "remat"):
                assert getattr(ours, f.name) == getattr(theirs, f.name), (family, f.name)


def test_port_modules_import_nothing_of_jax_or_transformers():
    """Every module this slice adds imports with jax, deepspeed_tpu,
    transformers and safetensors made unimportable."""
    mods = ["deepspeed_tpu_torch.checkpoint.hf", "deepspeed_tpu_torch.models.opt",
            "deepspeed_tpu_torch.models.parallel_block", "deepspeed_tpu_torch.models.falcon",
            "deepspeed_tpu_torch.models.phi", "deepspeed_tpu_torch.models.qwen2",
            "deepspeed_tpu_torch.models.mistral",
            "deepspeed_tpu_torch.inference.v2.model_implementations.opt",
            "deepspeed_tpu_torch.inference.v2.model_implementations.parallel_block",
            "deepspeed_tpu_torch.inference.v2.engine_factory",
            "deepspeed_tpu_torch.inference.engine", "deepspeed_tpu_torch.runtime.engine"]
    code = ("import sys\n"
            "class Block:\n"
            "    def find_spec(self, name, path=None, target=None):\n"
            "        if name.split('.')[0] in ('jax', 'jaxlib', 'deepspeed_tpu', "
            "'transformers', 'safetensors', 'flax'):\n"
            "            raise ImportError('blocked: ' + name)\n"
            "sys.meta_path.insert(0, Block())\n"
            f"import importlib\nfor m in {mods!r}:\n    importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'deepspeed_tpu', "
            "'transformers', 'safetensors')]\n"
            "assert not bad, bad\nprint('ok')\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), out.stderr[-2000:]
