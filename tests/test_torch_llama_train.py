"""The port's Llama training forward and losses against the JAX package.

The same weights (the JAX model's init, moved with ``params_from_flax``) and
the same token batch go through ``deepspeed_tpu.models.llama.
LlamaForCausalLM`` and ``deepspeed_tpu_torch.models.llama.LlamaForCausalLM``;
the loss and every parameter's gradient must agree. On the CPU the JAX model
attends through ``mha_reference`` and the port through the flash plain
versions (``tests/test_torch_flash_attention.py`` holds those to the Pallas
kernels). A second model keeps vocab 32000 at a narrow width, so the loss
goes through the fused chunked CE (``FUSED_CE_MIN_VOCAB`` is 16384), which is
also compared alone against ``fused_linear_cross_entropy``.

Tolerance: everything is fp32 and differs only in summation order, so loss
and gradients agree to 1e-5 relative to the largest gradient element of each
parameter (gradients here are ~1e-3..1e-1).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepspeed_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from deepspeed_tpu.models.llama import LlamaForCausalLM as JaxLlama
from deepspeed_tpu.models.llama import llama_flops_per_token as jax_flops
from deepspeed_tpu.models.losses import fused_linear_cross_entropy as jax_flce
from deepspeed_tpu_torch.models import losses
from deepspeed_tpu_torch.models.llama import (LlamaConfig, LlamaForCausalLM,
                                              llama_flops_per_token,
                                              params_from_flax)

RTOL = 1e-5

NARROW_32K = dict(vocab_size=32000, hidden_size=32, intermediate_size=64,
                  num_hidden_layers=1, num_attention_heads=2,
                  num_key_value_heads=1, max_position_embeddings=64)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def jax_loss_and_grads(jcfg, batch, seed=0):
    model = JaxLlama(jcfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    params = model.init(jax.random.PRNGKey(seed), jb)["params"]
    loss, grads = jax.value_and_grad(
        lambda p: model.apply({"params": p}, jb))(params)
    return float(loss), np_tree(params), np_tree(grads)


def port_loss_and_grads(cfg, params, batch):
    model = LlamaForCausalLM(cfg)
    model.load_state_dict(params_from_flax(params))
    loss = model({k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    return float(loss.detach()), {n: p.grad for n, p in model.named_parameters()}


def assert_grads_close(got, want_tree):
    want = params_from_flax(want_tree)
    assert set(got) == set(want)
    for name, g in got.items():
        w = want[name]
        scale = float(w.abs().max())
        torch.testing.assert_close(g, w, rtol=0, atol=RTOL * max(scale, 1e-6),
                                   msg=name)


def token_batch(vocab, B=2, T=32, seed=0):
    ids = np.random.default_rng(seed).integers(0, vocab, (B, T)).astype(np.int32)
    return {"input_ids": ids, "labels": ids}


@pytest.mark.parametrize("shape", ["tiny", "narrow_vocab_32000"])
def test_loss_and_grads_match_jax_model(shape):
    kw = {} if shape == "tiny" else NARROW_32K
    # remat=False: the JAX model's recomputation changes no value and only
    # lengthens its compile
    jcfg = JaxLlamaConfig.tiny(dtype=jnp.float32, remat=False) if shape == "tiny" \
        else JaxLlamaConfig(dtype=jnp.float32, remat=False, **kw)
    cfg = LlamaConfig.tiny(dtype=torch.float32) if shape == "tiny" \
        else LlamaConfig(dtype=torch.float32, **kw)
    batch = token_batch(cfg.vocab_size)
    want_loss, params, want_grads = jax_loss_and_grads(jcfg, batch)
    if shape == "tiny":
        assert want_loss == pytest.approx(6.2573, abs=1e-4)   # ROADMAP anchor
    got_loss, got_grads = port_loss_and_grads(cfg, params, batch)
    assert got_loss == pytest.approx(want_loss, rel=RTOL)
    assert_grads_close(got_grads, want_grads)


def test_logits_without_labels_match_jax_model():
    jcfg = dataclasses.replace(JaxLlamaConfig.tiny(dtype=jnp.float32),
                               num_key_value_heads=4)
    ids = token_batch(512)["input_ids"]
    model = JaxLlama(jcfg)
    params = model.init(jax.random.PRNGKey(1), jnp.asarray(ids))["params"]
    want = np.asarray(model.apply({"params": params}, jnp.asarray(ids)))
    port = LlamaForCausalLM(dataclasses.replace(LlamaConfig.tiny(dtype=torch.float32),
                                                num_key_value_heads=4))
    port.load_state_dict(params_from_flax(np_tree(params)))
    with torch.no_grad():
        got = port(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


def test_activation_checkpointing_gives_the_same_gradients():
    """Recomputing each layer in backward (policy everything), saving every
    activation (policy nothing) and ``remat=False`` give the same values."""
    from deepspeed_tpu_torch.runtime.activation_checkpointing import checkpointing
    from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
    batch = {k: torch.from_numpy(v) for k, v in token_batch(512).items()}
    grads = []
    for remat, policy in ((True, "everything"), (True, "nothing"), (False, "everything")):
        checkpointing.configure(deepspeed_config=DeepSpeedConfig(
            {"train_batch_size": 1, "activation_checkpointing": {"policy": policy}}))
        torch.manual_seed(0)
        model = LlamaForCausalLM(LlamaConfig.tiny(dtype=torch.float32, remat=remat))
        model(batch).backward()
        grads.append([p.grad for p in model.parameters()])
    checkpointing.reset()
    for other in grads[1:]:
        for a, b in zip(grads[0], other):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-7)


@pytest.mark.parametrize("ignore_index", [None, -100])
def test_fused_linear_cross_entropy_matches_jax(ignore_index):
    rng = np.random.default_rng(3)
    N, D, V = 24, 16, 20000
    x = rng.standard_normal((N, D)).astype(np.float32)
    head = (0.1 * rng.standard_normal((V, D))).astype(np.float32)
    labels = rng.integers(0, V, N).astype(np.int32)
    if ignore_index is not None:
        labels[::5] = ignore_index
    g = rng.standard_normal(N).astype(np.float32)
    valid = labels != -100
    lab_jax = np.where(valid, labels, 0)   # the JAX op takes valid ids only

    nll, vjp = jax.vjp(lambda a, b: jax_flce(a, b, jnp.asarray(lab_jax), 8192),
                       jnp.asarray(x), jnp.asarray(head))
    dx, dh = vjp(jnp.asarray(g * valid))
    tx = torch.from_numpy(x).requires_grad_()
    th = torch.from_numpy(head).requires_grad_()
    got = losses.fused_linear_cross_entropy(tx, th, torch.from_numpy(labels))
    (got * torch.from_numpy(g * valid)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy()[valid], np.asarray(nll)[valid],
                               rtol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(dx), atol=1e-6)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(dh), atol=1e-6)


def test_plain_head_losses_match_jax():
    from deepspeed_tpu.models import losses as jl
    rng = np.random.default_rng(4)
    # V > 100: the JAX gather wraps the ignored -100 onto a real column (its
    # loss is masked out); with V < 100 it reads out of range and gives nan
    logits = rng.standard_normal((2, 9, 150)).astype(np.float32)
    labels = rng.integers(0, 150, (2, 9)).astype(np.int32)
    labels[0, 3] = -100
    for ignore in (None, -100):
        lab = labels if ignore else np.where(labels < 0, 0, labels)
        want = float(jl.next_token_loss(jnp.asarray(logits), jnp.asarray(lab),
                                        ignore_index=ignore))
        got = float(losses.next_token_loss(torch.from_numpy(logits),
                                           torch.from_numpy(lab), ignore_index=ignore))
        assert got == pytest.approx(want, rel=1e-6)


def test_flops_per_token_matches_jax():
    for preset in ("tiny", "llama2_7b", "llama2_70b"):
        cfg = getattr(LlamaConfig, preset)()
        jcfg = getattr(JaxLlamaConfig, preset)()
        assert llama_flops_per_token(cfg, 2048) == jax_flops(jcfg, 2048)
    assert LlamaConfig.llama2_7b(num_hidden_layers=8).num_parameters() == 1_881_214_976
