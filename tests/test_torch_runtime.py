"""The port's training runtime pieces against the JAX package's, on the CPU:
LR schedules, loss scaling, the optimizer update, global-norm clipping and
overflow checks, the dataloader, and the config system (the cases of
``tests/test_config.py``, plus the settings the port refuses with
``NotImplementedError``).

Tolerances: the schedules and the optimizer run in float64 (Python floats)
or fp32 here and in fp32 in the JAX package, so they agree to 1e-6 relative
(schedules also to 1e-9 absolute, fp32's resolution at an lr of 1e-2, where
the cosine schedule nears 0); the loss-scale state machine and the
dataloader must agree exactly.
"""

import json

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from deepspeed_tpu.ops.adam import build_optimizer as jax_build_optimizer
from deepspeed_tpu.ops.adam import set_lr as jax_set_lr
from deepspeed_tpu.runtime import lr_schedules as jax_sched
from deepspeed_tpu.runtime import utils as jax_utils
from deepspeed_tpu.runtime.config import FP16Config as JaxFP16Config
from deepspeed_tpu.runtime.dataloader import DeepSpeedDataLoader as JaxLoader
from deepspeed_tpu.runtime.fp16 import loss_scaler as jax_scaler
from deepspeed_tpu_torch.ops.adam import build_optimizer, set_lr
from deepspeed_tpu_torch.runtime import lr_schedules as sched
from deepspeed_tpu_torch.runtime import utils
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig, FP16Config
from deepspeed_tpu_torch.runtime.dataloader import DeepSpeedDataLoader, RepeatingLoader
from deepspeed_tpu_torch.runtime.fp16 import loss_scaler

SCHEDULES = [
    ("WarmupLR", dict(warmup_min_lr=1e-4, warmup_max_lr=1e-2, warmup_num_steps=10)),
    ("WarmupLR", dict(warmup_max_lr=1e-2, warmup_num_steps=10, warmup_type="linear")),
    ("WarmupDecayLR", dict(total_num_steps=100, warmup_max_lr=1e-2, warmup_num_steps=10)),
    ("WarmupCosineLR", dict(total_num_steps=100, warmup_num_steps=10, warmup_max_lr=1e-2,
                            warmup_min_ratio=0.1)),
    ("LRRangeTest", dict(lr_range_test_min_lr=1e-3, lr_range_test_step_size=10)),
    ("LRRangeTest", dict(lr_range_test_min_lr=1e-3, lr_range_test_step_size=10,
                         lr_range_test_staircase=True)),
    ("OneCycle", dict(cycle_min_lr=1e-3, cycle_max_lr=1e-2, cycle_first_step_size=10,
                      decay_step_size=5, decay_lr_rate=0.5)),
    (None, dict()),
]


@pytest.mark.parametrize("name,params", SCHEDULES)
def test_lr_schedules_match_jax(name, params):
    ours = sched.get_lr_schedule(name, params, base_lr=3e-3)
    theirs = jax_sched.get_lr_schedule(name, params, base_lr=3e-3)
    for step in (0, 1, 2, 5, 9, 10, 11, 20, 37, 55, 99, 100, 150):
        assert ours(step) == pytest.approx(float(theirs(step)), rel=1e-6, abs=1e-9), step


def test_unknown_schedule_raises_and_shim_surface():
    with pytest.raises(ValueError):
        sched.get_lr_schedule("NoSuchSchedule", {})
    shim = sched.LRSchedulerShim(sched.warmup_lr(warmup_max_lr=1.0, warmup_num_steps=4))
    shim.step()
    shim.step()
    assert shim.get_lr() == [pytest.approx(np.log(2) / np.log(4))]
    assert shim.state_dict() == {"last_batch_iteration": 1}


@pytest.mark.parametrize("fp16", [
    dict(hysteresis=2, loss_scale_window=3),
    dict(hysteresis=1, loss_scale_window=2, min_loss_scale=64.0),
    dict(hysteresis=3, loss_scale_window=4, consecutive_hysteresis=True),
])
def test_update_loss_scale_sequences_match_jax(fp16):
    cfg = dict(enabled=True, initial_scale_power=8, **fp16)
    ours_cfg, theirs_cfg = FP16Config(cfg), JaxFP16Config(cfg)
    ours = loss_scaler.init_loss_scale_state(ours_cfg)
    theirs = jax_scaler.init_loss_scale_state(theirs_cfg)
    flags = [0, 1, 1, 0, 0, 0, 0, 1, 0, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0, 1]
    for flag in flags:
        ours = loss_scaler.update_loss_scale(ours, flag, ours_cfg, True)
        theirs = jax_scaler.update_loss_scale(theirs, jnp.asarray(bool(flag)),
                                              theirs_cfg, True)
        assert (ours.loss_scale, ours.good_steps, ours.hysteresis) == (
            float(theirs.loss_scale), int(theirs.good_steps), int(theirs.hysteresis))
    static = loss_scaler.init_loss_scale_state(FP16Config(dict(loss_scale=128.0)))
    assert loss_scaler.update_loss_scale(static, True, ours_cfg, False) == static


@pytest.mark.parametrize("name,params", [
    ("AdamW", dict(lr=1e-2, weight_decay=0.1)),
    ("Adam", dict(lr=1e-2, betas=[0.8, 0.99], weight_decay=0.05)),
    ("Adam", dict(lr=1e-2, weight_decay=0.05, adam_w_mode=False)),
])
def test_optimizer_matches_optax(name, params):
    rng = np.random.default_rng(0)
    shapes = [(7, 5), (11,)]
    p0 = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) for s in shapes] for _ in range(5)]
    lrs = [1e-2, 5e-3, 2e-2, 1e-3, 1e-2]

    tx, _ = jax_build_optimizer(name, params)
    jp = [jnp.asarray(p) for p in p0]
    state = tx.init(jp)
    ours = [torch.from_numpy(p.copy()) for p in p0]
    opt, base_lr = build_optimizer(name, params, ours)
    assert base_lr == params["lr"]
    for g, lr in zip(grads, lrs):
        updates, state = tx.update([jnp.asarray(x) for x in g],
                                   jax_set_lr(state, lr), jp)
        jp = optax.apply_updates(jp, updates)
        set_lr(opt, lr)
        for p, x in zip(ours, g):
            p.grad = torch.from_numpy(x)
        opt.step()
    for a, b in zip(ours, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)


def test_unported_optimizer_raises():
    """Every name of JAX's build_optimizer is ported (name kept): Lamb builds, and
    an unknown name raises JAX build_optimizer's ValueError."""
    from deepspeed_tpu_torch.ops.adam import Lamb
    assert isinstance(build_optimizer("Lamb", {}, [torch.zeros(2)])[0], Lamb)
    with pytest.raises(ValueError, match="Unknown optimizer type"):
        build_optimizer("Novograd", {}, [torch.zeros(2)])


def test_norm_clip_overflow_match_jax():
    rng = np.random.default_rng(1)
    grads = [rng.standard_normal(s).astype(np.float32) for s in ((4, 3), (5,))]
    norm = float(jax_utils.global_norm([jnp.asarray(g) for g in grads]))
    t = [torch.from_numpy(g.copy()) for g in grads]
    assert float(utils.global_norm(t)) == pytest.approx(norm, rel=1e-6)
    want, _ = jax_utils.clip_grads_by_global_norm([jnp.asarray(g) for g in grads], 0.5)
    utils.clip_grads_by_global_norm(t, 0.5)
    for a, b in zip(t, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    assert not bool(utils.has_overflow(t))
    t[1][2] = float("inf")
    assert bool(utils.has_overflow(t))
    assert bool(jax_utils.has_overflow([jnp.asarray(x.numpy()) for x in t]))


def test_dataloader_matches_jax_and_repeats():
    data = {"input_ids": np.arange(40).reshape(10, 4), "labels": np.arange(10)}
    ours, theirs = DeepSpeedDataLoader(data, 3), JaxLoader(data, 3)
    assert len(ours) == len(theirs) == 3
    for _ in range(2):   # two epochs: the shuffle stream continues
        for a, b in zip(ours, theirs):
            for k in data:
                np.testing.assert_array_equal(a[k], b[k])
    samples = [{"x": np.full(2, i)} for i in range(5)]
    batches = list(DeepSpeedDataLoader(samples, 2, shuffle=False))
    assert [b["x"].tolist() for b in batches] == [[[0, 0], [1, 1]], [[2, 2], [3, 3]]]
    rep = RepeatingLoader(DeepSpeedDataLoader(samples, 2, shuffle=False))
    assert [next(rep)["x"][0, 0] for _ in range(5)] == [0, 2, 0, 2, 0]


# ---------------------------------------------------------------------------
# config: the cases of tests/test_config.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cfg,dp,want", [
    ({"train_batch_size": 32}, 4, (32, 8, 1)),
    ({"train_batch_size": 32, "train_micro_batch_size_per_gpu": 2}, 4, (32, 2, 4)),
    ({"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 3}, 2, (12, 2, 3)),
    ({"train_batch_size": 16, "train_micro_batch_size_per_gpu": "auto",
      "gradient_accumulation_steps": "auto"}, 4, (16, 4, 1)),
])
def test_batch_triple(cfg, dp, want):
    assert DeepSpeedConfig(cfg).resolve_batch_params(dp) == want


@pytest.mark.parametrize("cfg,exc,match", [
    ({"train_batch_size": 30, "train_micro_batch_size_per_gpu": 4,
      "gradient_accumulation_steps": 2}, ValueError, "Check batch"),
    ({}, ValueError, "At least one"),
])
def test_batch_triple_errors(cfg, exc, match):
    with pytest.raises(exc, match=match):
        DeepSpeedConfig(cfg).resolve_batch_params(4)


@pytest.mark.parametrize("cfg,match", [
    ({"fp16": {"enabled": True}, "bf16": {"enabled": True}}, "cannot both"),
    ({"train_batch_size": 8, "zero_optimisation": {"stage": 3}},
     "did you mean 'zero_optimization'"),
    ({"train_batch_size": 8, "qqqqq": 1}, "Unknown top-level config key"),
    ({"train_batch_size": 8, "zero_optimization": {"stage": 5}}, "invalid ZeRO stage"),
])
def test_config_errors_match_jax(cfg, match):
    from deepspeed_tpu.runtime.config import DeepSpeedConfig as JaxConfig
    for cls in (DeepSpeedConfig, JaxConfig):
        with pytest.raises(ValueError, match=match):
            cls(cfg)


def test_config_sections_parse_like_jax(tmp_path):
    cfg = DeepSpeedConfig({
        "train_batch_size": 8, "zero_allow_untested_optimizer": True, "cpu_offload": True,
        "gradient_clipping": "auto", "fp16": {"enabled": "auto"},
        "zero_optimization": {"stage": 3, "sub_group_size": 1000,
                              "offload_optimizer": {"device": "cpu", "ratio": 0.5},
                              "stage3_gather_fp16_weights_on_model_save": True},
        "optimizer": {"type": "Adam", "params": {"lr": 1e-3, "betas": [0.9, 0.99]}},
        "scheduler": {"type": "WarmupLR", "params": {"warmup_num_steps": 10}}})
    z = cfg.zero_config
    assert (z.stage, z.sub_group_size, z.offload_optimizer.device,
            z.offload_optimizer.ratio) == (3, 1000, "cpu", 0.5)
    assert z.stage3_gather_16bit_weights_on_model_save is True and cfg.zero_enabled
    assert cfg.gradient_clipping == 0.0 and cfg.fp16.enabled is False
    assert cfg.optimizer.params["lr"] == 1e-3 and cfg.scheduler.type == "WarmupLR"
    with pytest.raises(NotImplementedError, match="ZeRO offload"):
        cfg.check_supported()
    p = tmp_path / "ds_config.json"
    p.write_text(json.dumps({"train_batch_size": 16,
                             "fp16": {"enabled": True, "initial_scale_power": 8}}))
    cfg = DeepSpeedConfig(str(p))
    assert cfg.train_batch_size == 16 and cfg.fp16.initial_scale_power == 8
    cfg.check_supported()


@pytest.mark.parametrize("section,item", [
    # MiCS and qwZ are ported: these two cases (ids kept) hold that the
    # config now accepts them
    pytest.param({"zero_optimization": {"stage": 2, "mics_shard_size": 2}}, None,
                 id="section0-A1"),
    pytest.param({"zero_optimization": {"zero_quantized_weights": True,
                                        "zero_quantized_nontrainable_weights": True},
                  "overlap": {"schedule": True}}, None, id="section1-A10"),
    ({"pipeline": {"stages": 2}}, "A12"),
    ({"sequence_parallel_size": 2}, "A12"),
    ({"tensor_parallel": {"tp_size": 2}}, "A12"),
    # prefetch_batches and cpu_checkpointing are ported (ids kept): the
    # config accepts them
    pytest.param({"prefetch_batches": 2}, None, id="section5-A1"),
    pytest.param({"activation_checkpointing": {"cpu_checkpointing": True}}, None,
                 id="section6-A1"),
    ({"hybrid_engine": {"enabled": True}}, "A15"),
    ({"tensorboard": {"enabled": True}}, "A15"),
    ({"resilience": {"watchdog": {"enabled": True}}}, "A15"),
])
def test_unported_settings_name_their_roadmap_item(section, item):
    cfg = DeepSpeedConfig(dict({"train_batch_size": 8}, **section))
    if item is None:
        cfg.check_supported()
        return
    with pytest.raises(NotImplementedError, match=item):
        cfg.check_supported()


def test_top_level_api():
    import argparse
    import deepspeed_tpu_torch as d
    p = d.add_config_arguments(argparse.ArgumentParser())
    args = p.parse_args(["--deepspeed", "--deepspeed_config", "c.json"])
    assert args.deepspeed and args.deepspeed_config == "c.json"
    from deepspeed_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    model = LlamaForCausalLM(LlamaConfig.tiny(dtype=torch.float32))
    if torch.cuda.is_available():
        engine, *_ = d.initialize(model=model, config={"train_batch_size": 2})
        assert engine.device.type == "cuda"
    else:   # entry points run on the card unless asked for the CPU
        with pytest.raises(RuntimeError, match="no CUDA device"):
            d.initialize(model=model, config={"train_batch_size": 2})
