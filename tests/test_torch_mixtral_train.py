"""The port's Mixtral training forward and engine against the JAX package, on the CPU.

A small Mixtral (hidden 128, expert width 256, 4 experts, top-2, 2 layers,
vocab 512; megablox needs 128-multiples) with the JAX model's init, moved
with ``params_from_flax``, goes through ``deepspeed_tpu.models.mixtral.
MixtralForCausalLM`` and ``deepspeed_tpu_torch.models.mixtral.
MixtralForCausalLM`` for each ``moe_backend`` (``gmm``, ``indices``,
``einsum``), with the port's activation checkpointing on and off: the loss
(LM loss plus the router aux loss) and every parameter's gradient must
agree. ``capacity_factor`` 1.0 makes the capacity (16 of 32 tokens' 64
choices per expert at most) drop choices, so the drop path is in the
comparison. The JAX ``gmm`` backend runs megablox in interpret mode, the
port's the grouped-GEMM kernels' plain versions through their autograd
backward (the dx and dW plain versions). Then both engines take 6
optimizer steps (2 micro-batches each, AdamW, WarmupDecayLR, clipping 1.0)
through ``initialize`` on the ``gmm`` backend, as ``tests/test_torch_engine.py``
does for Llama.

Tolerances: everything is fp32 and differs only in summation order. Loss to
1e-5 relative; gradients to 1e-5 of each parameter's largest gradient
element; engine losses to 1e-5 relative and master parameters to 2e-5
absolute (they move by up to ~0.02 over 6 steps at lr 3e-3).
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models.mixtral import MixtralConfig as JaxMixtralConfig
from deepspeed_tpu.models.mixtral import MixtralForCausalLM as JaxMixtral
from deepspeed_tpu.parallel.topology import MeshTopology
from deepspeed_tpu_torch.models.mixtral import (MixtralConfig, MixtralForCausalLM,
                                                params_from_flax)
from deepspeed_tpu_torch.runtime.activation_checkpointing import checkpointing

SMALL = dict(vocab_size=512, hidden_size=128, intermediate_size=256,
             num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
             num_local_experts=4, max_position_embeddings=128, capacity_factor=1.0)
RTOL = 1e-5
GAS, MICRO, T, STEPS = 2, 2, 16, 6


def jax_config(backend):
    return JaxMixtralConfig(**SMALL, moe_backend=backend, dtype=jnp.float32,
                            remat=False)


def port_config(backend, remat=True):
    return MixtralConfig(**SMALL, moe_backend=backend, dtype=torch.float32,
                         remat=remat)


def token_batches(n, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ids = rng.integers(0, SMALL["vocab_size"], (MICRO, T)).astype(np.int32)
        out.append({"input_ids": ids, "labels": ids})
    return out


@functools.lru_cache(maxsize=None)
def jax_params():
    """The JAX model's init (the same tree for every backend)."""
    batch = token_batches(1)[0]
    init = jax.jit(JaxMixtral(jax_config("einsum")).init)
    return jax.tree.map(np.asarray, init(jax.random.PRNGKey(0), batch)["params"])


@functools.lru_cache(maxsize=None)
def jax_loss_and_grads(backend):
    model = JaxMixtral(jax_config(backend))
    batch = {k: jnp.asarray(v) for k, v in token_batches(1)[0].items()}
    loss, grads = jax.value_and_grad(
        lambda p: model.apply({"params": p}, batch))(jax_params())
    return float(loss), jax.tree.map(np.asarray, grads)


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no_remat"])
@pytest.mark.parametrize("backend", ["gmm", "indices", "einsum"])
def test_loss_and_grads_match_jax_model(backend, remat):
    want_loss, want_grads = jax_loss_and_grads(backend)
    checkpointing.reset()
    model = MixtralForCausalLM(port_config(backend, remat))
    model.load_state_dict(params_from_flax(jax_params()))
    batch = {k: torch.from_numpy(v) for k, v in token_batches(1)[0].items()}
    loss = model(batch)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), want_loss, rtol=RTOL)
    want = params_from_flax(want_grads)
    got = {n: p.grad for n, p in model.named_parameters()}
    assert set(got) == set(want)
    for name, g in got.items():
        scale = max(float(want[name].abs().max()), 1e-6)
        torch.testing.assert_close(g, want[name], rtol=0, atol=RTOL * scale, msg=name)


def test_aux_loss_is_in_the_loss():
    """The loss is the LM loss plus router_aux_loss_coef times the mean of the
    layers' aux losses: a larger coefficient raises it by the aux term."""
    params = params_from_flax(jax_params())
    batch = {k: torch.from_numpy(v) for k, v in token_batches(1)[0].items()}
    losses = []
    for coef in (0.0, 1.0):
        cfg = dataclasses.replace(port_config("gmm"), router_aux_loss_coef=coef)
        model = MixtralForCausalLM(cfg)
        model.load_state_dict(params)
        with torch.no_grad():
            losses.append(float(model(batch)))
    aux = losses[1] - losses[0]
    assert 0.9 < aux < 2.0     # E * sum(me * ce) is 1 for a uniform router


def train_config():
    return {"train_batch_size": GAS * MICRO,
            "train_micro_batch_size_per_gpu": MICRO,
            "gradient_accumulation_steps": GAS,
            "optimizer": {"type": "AdamW", "params": {"lr": 3e-3, "weight_decay": 0.01}},
            "scheduler": {"type": "WarmupDecayLR",
                          "params": {"total_num_steps": STEPS, "warmup_num_steps": 2}},
            "gradient_clipping": 1.0}


def test_six_steps_match_jax_engine():
    micro = token_batches(GAS * STEPS, seed=1)
    params = jax_params()
    jengine, *_ = deepspeed_tpu.initialize(
        model=JaxMixtral(jax_config("gmm")), model_parameters=params,
        config=train_config(), mesh=MeshTopology(devices=jax.devices()[:1]))
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=MixtralForCausalLM(port_config("gmm")),
        model_parameters=params_from_flax(params), config=train_config(), device="cpu")
    want_losses, got_losses = [], []
    for b in micro:
        for eng, out in ((jengine, want_losses), (engine, got_losses)):
            loss = eng(b)
            eng.backward(loss)
            eng.step()
            out.append(float(loss.detach() if hasattr(loss, "detach") else loss))
    assert engine.global_steps == jengine.global_steps == STEPS
    np.testing.assert_allclose(got_losses, want_losses, rtol=RTOL)
    want_master = params_from_flax(jax.tree.map(np.asarray,
                                                jengine.get_model_parameters()))
    got_master = engine.get_model_parameters()
    start = params_from_flax(params)
    for name, w in want_master.items():
        torch.testing.assert_close(got_master[name], w, rtol=0, atol=2e-5, msg=name)
    moved = max(float((got_master[n] - start[n]).abs().max()) for n in start)
    assert moved > 1e-3
    assert engine.get_global_grad_norm() == pytest.approx(
        jengine.get_global_grad_norm(), rel=1e-4)
