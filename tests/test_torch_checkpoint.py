"""Checkpoint save/load of the port's training engine, on the CPU.

A tiny Llama trains through ``initialize`` for a few optimizer steps, saves,
and trains on; a fresh engine (other initial weights) loads the tag and
takes the same steps. Its losses and fp32 masters must equal the
uninterrupted run's bit for bit: the same operations run in the same order
on restored state, so no tolerance applies. Mirrors
``tests/test_engine.py:160,176,193`` (round trip, bf16 leaves, client state)
and the recovery cases of the JAX checkpoint engine: ``latest``, a corrupt
shard quarantined to ``<tag>.corrupt`` with the fallback to the earlier
tag, a missing manifest, a leaf count that disagrees, ``load_module_only``.
The multi-rank cases (W = 4: ZeRO stages 1-3, qgZ with error feedback,
``ep`` 2 x ``dp`` 2) run in ``tests/test_torch_zero.py``.
"""

import copy
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from deepspeed_tpu_torch.runtime.checkpoint_engine.native_engine import (
    CorruptCheckpointError, NativeCheckpointEngine)

MICRO, GAS, T = 2, 2, 16


def config(precision="fp32", **extra):
    cfg = {"train_batch_size": MICRO * GAS, "train_micro_batch_size_per_gpu": MICRO,
           "gradient_accumulation_steps": GAS,
           "optimizer": {"type": "AdamW", "params": {"lr": 3e-3, "weight_decay": 0.01}},
           "scheduler": {"type": "WarmupDecayLR",
                         "params": {"total_num_steps": 8, "warmup_num_steps": 2}},
           "gradient_clipping": 1.0}
    if precision == "bf16":
        cfg["bf16"] = {"enabled": True}
    if precision == "fp16":
        # 2^20 overflows at first: the restored run must keep skipping and
        # halving where the uninterrupted one did
        cfg["fp16"] = {"enabled": True, "initial_scale_power": 20, "hysteresis": 1,
                       "loss_scale_window": 2}
    cfg.update(extra)
    return cfg


def batches(n, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ids = rng.integers(0, 512, (MICRO, T)).astype(np.int32)
        out.append({"input_ids": ids, "labels": ids})
    return out


def make_engine(precision="fp32", seed=0, **extra):
    torch.manual_seed(seed)
    model = LlamaForCausalLM(LlamaConfig.tiny(dtype=torch.float32))
    engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=config(precision, **extra),
                                                device="cpu")
    return engine


def train(engine, micro_batches):
    losses = []
    for b in micro_batches:
        loss = engine(b)
        engine.backward(loss)
        engine.step()
        losses.append(loss.detach().float().clone())
    return torch.stack(losses)


def assert_same_state(a, b):
    pa, pb = a.get_model_parameters(), b.get_model_parameters()
    assert pa.keys() == pb.keys()
    for k in pa:
        assert torch.equal(pa[k], pb[k]), k


@pytest.mark.parametrize("precision", ["fp32", "bf16", "fp16"])
def test_checkpoint_roundtrip(tmp_path, precision):
    data = batches(12, seed=11)
    ref = make_engine(precision)
    train(ref, data[:4])
    path = ref.save_checkpoint(str(tmp_path))
    assert path.endswith("global_step2")
    saved = (ref.cur_scale, ref.skipped_steps)
    ref_losses = train(ref, data[4:])

    resumed = make_engine(precision, seed=99)
    got, client = resumed.load_checkpoint(str(tmp_path))
    assert got == path and client == {}
    assert (resumed.global_steps, resumed.micro_steps, resumed.global_samples) == (2, 4, 8)
    assert (resumed.cur_scale, resumed.skipped_steps) == saved
    assert torch.equal(train(resumed, data[4:]), ref_losses)
    assert_same_state(resumed, ref)
    assert resumed.skipped_steps == ref.skipped_steps
    assert resumed.cur_scale == ref.cur_scale
    assert resumed.get_lr() == ref.get_lr()


def test_checkpoint_bf16_leaves(tmp_path):
    """bf16 working weights survive the npz round trip (numpy has no
    bfloat16: they are stored as int16 byte views)."""
    engine = make_engine("bf16")
    train(engine, batches(2))
    engine.save_checkpoint(str(tmp_path))
    leaves = NativeCheckpointEngine().read_manifest(
        os.path.join(tmp_path, "global_step1"))["leaves"][0]
    assert dict(leaves)["module.embed_tokens.weight"] == "bfloat16"
    fresh = make_engine("bf16", seed=5)
    fresh.load_checkpoint(str(tmp_path))
    p = dict(fresh.module.named_parameters())["embed_tokens.weight"]
    assert p.dtype == torch.bfloat16
    assert torch.equal(p, dict(engine.module.named_parameters())["embed_tokens.weight"])
    assert_same_state(fresh, engine)


def test_checkpoint_client_state(tmp_path):
    engine = make_engine()
    train(engine, batches(2))
    engine.save_checkpoint(str(tmp_path), client_state={"epoch": 7})
    _, client = make_engine().load_checkpoint(str(tmp_path))
    assert client["epoch"] == 7


def test_latest_and_explicit_tags(tmp_path):
    engine = make_engine()
    data = batches(4)
    train(engine, data[:2])
    engine.save_checkpoint(str(tmp_path), tag="first")
    train(engine, data[2:])
    engine.save_checkpoint(str(tmp_path), save_latest=False)
    assert (tmp_path / "latest").read_text() == "first"
    assert make_engine().load_checkpoint(str(tmp_path))[0].endswith("first")
    other = make_engine()
    assert other.load_checkpoint(str(tmp_path), tag="global_step2")[0].endswith("global_step2")
    assert other.global_steps == 2
    (tmp_path / "empty").mkdir()
    assert make_engine().load_checkpoint(str(tmp_path / "empty")) == (None, {})
    assert engine._checkpoint_tags(str(tmp_path)) == ["global_step2", "first"]


def corrupt_byte(path, offset=-100):
    with open(path, "r+b") as f:
        f.seek(offset, os.SEEK_END)
        b = f.read(1)
        f.seek(offset, os.SEEK_END)
        f.write(bytes([b[0] ^ 0xFF]))


def test_corrupt_shard_is_quarantined_and_the_earlier_tag_loads(tmp_path):
    engine = make_engine()
    data = batches(6)
    train(engine, data[:2])
    engine.save_checkpoint(str(tmp_path))                       # global_step1
    want = make_engine()
    want.load_checkpoint(str(tmp_path))
    train(engine, data[2:4])
    engine.save_checkpoint(str(tmp_path))                       # global_step2, latest
    corrupt_byte(tmp_path / "global_step2" / "arrays.npz")
    with pytest.raises(CorruptCheckpointError, match="arrays.npz"):
        NativeCheckpointEngine().verify(str(tmp_path / "global_step2"))
    resumed = make_engine()
    path, _ = resumed.load_checkpoint(str(tmp_path))
    assert path.endswith("global_step1") and resumed.global_steps == 1
    assert (tmp_path / "global_step2.corrupt").is_dir()
    assert not (tmp_path / "global_step2").exists()
    assert (tmp_path / "latest").read_text() == "global_step1"
    assert_same_state(resumed, want)


def test_missing_manifest_and_no_fallback(tmp_path):
    engine = make_engine()
    train(engine, batches(2))
    engine.save_checkpoint(str(tmp_path))
    os.remove(tmp_path / "global_step1" / "meta.json")
    with pytest.raises(CorruptCheckpointError, match="manifest missing"):
        make_engine().load_checkpoint(str(tmp_path))
    assert (tmp_path / "global_step1.corrupt").is_dir()


def test_leaf_count_mismatch(tmp_path):
    engine = make_engine()
    train(engine, batches(2))
    tag = engine.save_checkpoint(str(tmp_path))
    meta_path = os.path.join(tag, "meta.json")
    meta = json.load(open(meta_path))
    meta["num_leaves"] += 1
    json.dump(meta, open(meta_path, "w"))
    with pytest.raises(CorruptCheckpointError, match="meta.json.*leaf count"):
        NativeCheckpointEngine().verify(tag)
    with pytest.raises(CorruptCheckpointError):
        make_engine().load_checkpoint(str(tmp_path))


def test_load_module_only(tmp_path):
    engine = make_engine("bf16")
    data = batches(4)
    train(engine, data)
    engine.save_checkpoint(str(tmp_path))
    fresh = make_engine("bf16", seed=3)
    fresh.load_checkpoint(str(tmp_path), load_module_only=True)
    assert_same_state(fresh, engine)
    for leaf in fresh._leaves:               # moments untouched: no step taken
        st = fresh.optimizer.state[leaf.master]
        assert st["step"] == 0 and not st["mu"].any() and not st["nu"].any()
    full = make_engine("bf16", seed=3)
    full.load_checkpoint(str(tmp_path), load_optimizer_states=True)
    st = full.optimizer.state[full._leaves[0].master]
    assert st["step"] == 2 and st["mu"].any()


def test_structure_and_layout_changes_raise(tmp_path):
    engine = make_engine()
    train(engine, batches(2))
    engine.save_checkpoint(str(tmp_path))
    with pytest.raises(NotImplementedError, match="A15"):
        make_engine(zero_optimization={"stage": 1}).load_checkpoint(str(tmp_path))
    torch.manual_seed(0)
    deeper = dataclasses.replace(LlamaConfig.tiny(dtype=torch.float32), num_hidden_layers=3)
    wider = LlamaForCausalLM(deeper)
    other, *_ = deepspeed_tpu_torch.initialize(model=wider, config=config(), device="cpu")
    with pytest.raises(ValueError, match="structure changed"):
        other.load_checkpoint(str(tmp_path))
    with pytest.raises(NotImplementedError, match="A15"):
        engine.save_checkpoint(str(tmp_path), async_save=True)
    # save_16bit_model writes an HF export of the masters, which loads back
    from deepspeed_tpu_torch.checkpoint import hf
    path = engine.save_16bit_model(str(tmp_path / "hf"))
    assert path.endswith("model.safetensors")
    back = hf.load_pretrained(str(tmp_path / "hf"), device="cpu").state_dict()
    assert all(torch.equal(back[n], m) for n, m in engine.get_model_parameters().items())


def test_state_dict_round_trips(tmp_path):
    """The engine's and the optimizer's state dicts carry everything a
    resume needs; the model parameters agree before and after."""
    data = batches(6)
    ref = make_engine("bf16")
    train(ref, data[:2])
    other = make_engine("bf16", seed=4)
    other.load_state_dict({k: v.clone() for k, v in ref.state_dict().items()})
    # a torch optimizer's state_dict holds its live tensors: copy, as a save would
    other.optimizer.load_state_dict(copy.deepcopy(ref.optimizer.state_dict()))
    other.global_steps, other.micro_steps = ref.global_steps, ref.micro_steps
    assert_same_state(other, ref)
    assert torch.equal(train(other, data[2:]), train(ref, data[2:]))
    assert_same_state(other, ref)
