"""The port's training engine against the JAX package's, on the CPU.

Both engines start from the same parameters (the JAX tiny Llama's init) and
take the same micro-batches through ``initialize`` and
``engine(batch); engine.backward(loss); engine.step()``: AdamW with weight
decay, ``WarmupDecayLR``, gradient clipping at 1.0 and 2 micro-batches per
optimizer step, for 6 optimizer steps. The JAX engine runs on a one-device
mesh, so its micro-batch is the port's. Per-micro-step losses and the final
fp32 master parameters are compared, as is an fp16 run whose loss scale
overflows (both engines skip the same steps and halve the scale).

Tolerances:
- fp32: the two engines differ only in summation order (and the attention
  formulation, dense in JAX, flash plain version here, equal in exact
  arithmetic), so losses agree to 1e-5 relative and master parameters to
  2e-5 absolute (they move by up to ~0.02 over 6 steps at lr 3e-3).
- bf16: both round activations and gradients to bf16, but at different
  places (the JAX model's dense attention normalizes probabilities before the
  bf16 cast, flash rounds unnormalized ones; XLA and PyTorch round GEMM
  outputs differently), which moves the loss by ~2e-4 relative. Losses agree
  to 2e-3 relative; the parameter updates (final minus initial master)
  agree to 10% in relative L2 norm (6% measured), where a sign-flipped
  update of every parameter would give ~200% and no update at all 100%.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from deepspeed_tpu.models.llama import LlamaForCausalLM as JaxLlama
from deepspeed_tpu.parallel.topology import MeshTopology
from deepspeed_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM, params_from_flax

GAS, MICRO, T, STEPS = 2, 2, 32, 6


def train_config(precision):
    cfg = {"train_batch_size": GAS * MICRO,
           "train_micro_batch_size_per_gpu": MICRO,
           "gradient_accumulation_steps": GAS,
           "optimizer": {"type": "AdamW",
                         "params": {"lr": 3e-3, "weight_decay": 0.01}},
           "scheduler": {"type": "WarmupDecayLR",
                         "params": {"total_num_steps": STEPS,
                                    "warmup_num_steps": 2}},
           "gradient_clipping": 1.0}
    if precision == "bf16":
        cfg["bf16"] = {"enabled": True}
    if precision == "fp16":
        cfg["fp16"] = {"enabled": True, "initial_scale_power": 30,
                       "hysteresis": 1}
    return cfg


def batches(n, vocab=512, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ids = rng.integers(0, vocab, (MICRO, T)).astype(np.int32)
        out.append({"input_ids": ids, "labels": ids})
    return out


def jax_params(dtype):
    # remat=False: the JAX model's recomputation changes no value and only
    # lengthens its compile
    model = JaxLlama(JaxLlamaConfig.tiny(dtype=dtype, remat=False))
    ids = jnp.asarray(batches(1)[0]["input_ids"])
    return model, jax.tree.map(np.asarray,
                               model.init(jax.random.PRNGKey(0), ids)["params"])


def run_jax(precision, micro_batches):
    dtype = {"fp32": jnp.float32, "bf16": jnp.bfloat16, "fp16": jnp.float16}[precision]
    model, params = jax_params(dtype)
    engine, *_ = deepspeed_tpu.initialize(
        model=model, model_parameters=params, config=train_config(precision),
        mesh=MeshTopology(devices=jax.devices()[:1]))
    losses = []
    for b in micro_batches:
        loss = engine(b)
        engine.backward(loss)
        engine.step()
        losses.append(float(loss))
    master = params_from_flax(jax.tree.map(np.asarray, engine.get_model_parameters()))
    return params, losses, master, engine


def run_port(precision, params, micro_batches):
    model = LlamaForCausalLM(LlamaConfig.tiny(dtype=torch.float32))
    engine, optimizer, _, scheduler = deepspeed_tpu_torch.initialize(
        model=model, model_parameters=params_from_flax(params),
        config=train_config(precision), device="cpu")
    losses = []
    for b in micro_batches:
        loss = engine(b)
        engine.backward(loss)
        engine.step()
        losses.append(float(loss.detach()))
    return losses, engine.get_model_parameters(), engine


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_six_steps_match_jax_engine(precision):
    micro = batches(GAS * STEPS)
    params, want_losses, want_master, jax_engine = run_jax(precision, micro)
    got_losses, got_master, engine = run_port(precision, params, micro)
    assert engine.global_steps == jax_engine.global_steps == STEPS
    assert engine.get_lr() == pytest.approx(jax_engine.get_lr(), rel=1e-6)
    start = params_from_flax(params)
    if precision == "fp32":
        np.testing.assert_allclose(got_losses, want_losses, rtol=1e-5)
        for name, w in want_master.items():
            torch.testing.assert_close(got_master[name], w, rtol=0, atol=2e-5, msg=name)
        assert engine.get_global_grad_norm() == pytest.approx(
            jax_engine.get_global_grad_norm(), rel=1e-4)
    else:
        np.testing.assert_allclose(got_losses, want_losses, rtol=2e-3)
        got = torch.cat([(got_master[n] - start[n]).flatten() for n in start])
        want = torch.cat([(want_master[n] - start[n]).flatten() for n in start])
        assert float((got - want).norm() / want.norm()) < 0.1
        assert next(engine.module.parameters()).dtype == torch.bfloat16
    assert got_losses[-1] < got_losses[0]


def test_fp16_overflow_skips_like_jax_engine():
    """Loss scale 2^30 overflows the fp16 gradients: both engines skip every
    step, halve the scale each time (hysteresis 1) and keep the master
    parameters."""
    micro = batches(4)
    params, want_losses, want_master, jax_engine = run_jax("fp16", micro)
    got_losses, got_master, engine = run_port("fp16", params, micro)
    assert engine.skipped_steps == jax_engine.skipped_steps == 2
    assert engine.cur_scale == jax_engine.cur_scale == 2.0 ** 28
    np.testing.assert_allclose(got_losses, want_losses, rtol=1e-2)
    start = params_from_flax(params)
    for name, w in want_master.items():
        assert torch.equal(got_master[name], start[name]), name
        torch.testing.assert_close(w, start[name], rtol=0, atol=0)


def test_train_batch_dataloader_and_accessors():
    micro = batches(4)
    data = {k: np.concatenate([b[k] for b in micro]) for k in micro[0]}
    model = LlamaForCausalLM(LlamaConfig.tiny(dtype=torch.float32))
    engine, optimizer, loader, scheduler = deepspeed_tpu_torch.initialize(
        model=model, training_data=data, config=train_config("fp32"), device="cpu")
    assert len(loader) == 4 and engine.train_batch_size() == GAS * MICRO
    assert engine.gradient_accumulation_steps() == GAS
    loss = engine.train_batch()
    assert loss.shape == () and engine.global_steps == 1 and engine.micro_steps == GAS
    assert engine.was_step_applied() and engine.get_global_grad_norm() > 0
    assert isinstance(optimizer, torch.optim.Optimizer)
    # WarmupDecayLR: the step that ran used lr(0), the next uses lr(1)
    assert engine.get_lr() == [0.0]
    assert scheduler.get_lr() == pytest.approx([3e-3])
    out = engine.eval_batch({"input_ids": micro[0]["input_ids"]})
    assert out.shape == (MICRO, T, 512)
    engine.set_lr(1e-4)
    engine.train_batch()
    assert engine.get_lr() == [1e-4] and engine.global_steps == 2


@pytest.mark.parametrize("section,match", [
    # MiCS is ported (id kept): at world 1 a shard group of 2 exceeds the
    # data-parallel world, the JAX topology's AssertionError
    pytest.param({"zero_optimization": {"stage": 1, "mics_shard_size": 2}},
                 (AssertionError, "exceeds the data-parallel world"), id="section0-A1"),
    ({"zero_optimization": {"offload_optimizer": {"device": "cpu"}}}, "A14"),
    ({"tensor_parallel": {"tp_size": 2}}, "A12"),
    # fused_step (accepted, one train_batch path), the dots policy and Lamb
    # are ported (ids kept): the engine builds and takes a step
    # (tests/test_torch_training_rest.py and tests/test_torch_optimizers.py
    # hold their values)
    pytest.param({"fused_step": True}, None, id="section3-A1"),
    pytest.param({"activation_checkpointing": {"policy": "dots"}}, None, id="section4-A1"),
    pytest.param({"optimizer": {"type": "Lamb"}}, None, id="section5-A1"),
])
def test_unported_settings_raise(section, match):
    cfg = dict(train_config("fp32"), **section)
    model = LlamaForCausalLM(LlamaConfig.tiny(dtype=torch.float32))
    if match is None:
        engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=cfg, device="cpu")
        loss = engine.train_batch(iter(batches(GAS)))
        assert np.isfinite(float(loss)) and engine.global_steps == 1
        return
    error, match = match if isinstance(match, tuple) else (NotImplementedError, match)
    with pytest.raises(error, match=match):
        deepspeed_tpu_torch.initialize(model=model, config=cfg, device="cpu")


@pytest.mark.parametrize("stage", [1, 2, 3])
def test_zero_stages_train_at_world_one(stage):
    """ZeRO stages 1-3 train in one process without a process group, as in
    the JAX package: with a world of one nothing is sharded, so the run is
    the stage-0 run exactly."""
    micro = batches(GAS * 2)
    _, params = jax_params(jnp.float32)
    want_losses, want_master, _ = run_port("fp32", params, micro)
    cfg = dict(train_config("fp32"), zero_optimization={
        "stage": stage, "stage3_param_persistence_threshold": 0})
    model = LlamaForCausalLM(LlamaConfig.tiny(dtype=torch.float32))
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=model, model_parameters=params_from_flax(params), config=cfg, device="cpu")
    losses = []
    for b in micro:
        loss = engine(b)
        engine.backward(loss)
        engine.step()
        losses.append(float(loss.detach()))
    assert engine.zero_optimization_stage() == stage and engine.global_steps == 2
    assert losses == want_losses
    got = engine.get_model_parameters()
    for name, w in want_master.items():
        assert torch.equal(got[name], w), name


def test_gradients_fold_in_only_through_engine_backward():
    """``engine.backward`` folds each gradient into its accumulator as
    autograd produces it and leaves no ``.grad``; a backward run outside the
    engine (a comparison on the same module) keeps its ``.grad`` and leaves
    the accumulators alone."""
    micro = batches(1)
    model = LlamaForCausalLM(LlamaConfig.tiny(dtype=torch.float32))
    engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=train_config("fp32"),
                                                device="cpu")
    engine.backward(engine(micro[0]))
    acc = [leaf.acc.clone() for leaf in engine._leaves]
    assert all(p.grad is None for p in model.parameters())
    assert all(float(a.abs().sum()) > 0 for a in acc)
    model(engine._to_device(micro[0])).backward()
    assert all(p.grad is not None for p in model.parameters())
    for leaf, a, p in zip(engine._leaves, acc, model.parameters()):
        assert torch.equal(leaf.acc, a)
        torch.testing.assert_close(p.grad, a, rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("stage", [0, 3])
def test_engine_is_freed_while_its_module_lives(stage):
    """The gradient hooks live in autograd's C++ state, out of the cycle
    collector's sight: they must hold the engine weakly, or a dropped
    engine's masters, moments and accumulators stay alive with the
    module."""
    import gc
    import weakref
    model = LlamaForCausalLM(LlamaConfig.tiny(dtype=torch.float32))
    cfg = dict(train_config("fp32"), zero_optimization={"stage": stage})
    engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=cfg, device="cpu")
    engine.backward(engine(batches(1)[0]))
    ref = weakref.ref(engine)
    del engine, _
    gc.collect()
    assert ref() is None
    model(model.embed_tokens.weight.new_zeros(2, 8, dtype=torch.long)).sum().backward()
