"""One rank of the 4-process gloo runs of ``tests/test_torch_training_rest.py``.

``python tests/test_torch_training_rest_worker.py RANK WORLD INIT_FILE INPUTS OUT``
joins a gloo process group through ``file://INIT_FILE`` and runs, on the
inputs ``torch.load(INPUTS)`` gives:

- ``zero.Init`` at ZeRO stages 1-3 (the tiny GPT-2) and under expert
  parallelism (the tiny Mixtral at ``ep`` 2 x dp 2): every rank's masters
  and working copies built born sharded, against the whole-module path
  (``from_seed``, then ``initialize``), and the whole leaves alive at once
  while they are drawn;
- the tensor-fragment accessors at stages 0, 1 and 3 (those of
  ``tests/test_checkpoint_universal.py``) on the tiny Llama after two
  steps and one more micro-step: full reads, local reads and writes;
- qgZ under MiCS (``mics_shard_size`` 2: dp 2 x dpr 2, stage 2), MiCS
  without qgZ, and qgZ under hpZ at the same dpr x dp split, on the tiny
  Llama.

It saves a dict of results to ``OUT``; the test module holds them against
each other and the JAX engines.
"""

import datetime
import os
import sys
import time
import weakref

import torch
import torch.distributed as tdist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import deepspeed_tpu_torch  # noqa: E402
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHeadModel  # noqa: E402
from deepspeed_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM  # noqa: E402
from deepspeed_tpu_torch.models.mixtral import (MixtralConfig,  # noqa: E402
                                                MixtralForCausalLM)
from deepspeed_tpu_torch.parallel import groups  # noqa: E402
from deepspeed_tpu_torch.runtime.zero import sharded_init  # noqa: E402
from deepspeed_tpu_torch.utils import tensor_fragment as tf  # noqa: E402

SEED = 42           # the config's default seed


def state(engine):
    """Every rank-local tensor of the engine's leaves, by role and name."""
    out = {}
    for leaf in engine._leaves:
        out[f"master.{leaf.name}"] = leaf.master.detach().clone()
        working = leaf.shard if leaf.param_dim is not None else leaf.param.data
        out[f"working.{leaf.name}"] = working.detach().clone()
    return out


def counted_leaves(alive):
    """``seeded_leaves`` recording, at each draw, how many whole leaves of
    earlier draws are still alive."""
    inner = sharded_init.seeded_leaves

    def wrapped(*a, **k):
        refs = []
        for name, p, value in inner(*a, **k):
            alive.append(sum(r() is not None for r in refs))
            refs.append(weakref.ref(value))
            yield name, p, value
    return wrapped


def zero_init_runs(inp, rank, out):
    gpt2 = GPT2Config.tiny(dtype=torch.float32)
    for stage in (1, 2, 3):
        config = {"train_batch_size": 4, "optimizer": {"type": "AdamW"},
                  "zero_optimization": {"stage": stage,
                                        "stage3_param_persistence_threshold": 0}}
        groups.reset()
        alive = []
        sharded_init.seeded_leaves, inner = counted_leaves(alive), sharded_init.seeded_leaves
        try:
            with deepspeed_tpu_torch.zero.Init(config=config):
                model = GPT2LMHeadModel(gpt2)
            assert sharded_init.is_meta(model)
            engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=config,
                                                        device="cpu")
        finally:
            sharded_init.seeded_leaves = inner
        born = state(engine)
        share = sum(t.numel() for k, t in born.items() if k.startswith("master."))
        groups.reset()
        whole = GPT2LMHeadModel.from_seed(gpt2, SEED, device="cpu")
        ref, *_ = deepspeed_tpu_torch.initialize(model=whole, config=config, device="cpu")
        out[f"zero_init_{stage}"] = dict(
            differs=[k for k, t in state(ref).items() if not torch.equal(t, born[k])],
            max_alive=max(alive), draws=len(alive), share=share,
            whole=sum(p.numel() for p in whole.parameters()),
            sharded=sum(leaf.master_dim is not None for leaf in engine._leaves))
    # expert slices keep their ep placement: ep 2 x dp 2
    mix = MixtralConfig.tiny(dtype=torch.float32)
    config = {"train_batch_size": 4, "expert_parallel_size": 2,
              "optimizer": {"type": "AdamW"}, "zero_optimization": {"stage": 1}}
    groups.reset()
    with deepspeed_tpu_torch.zero.Init(config=config):
        model = MixtralForCausalLM(mix, ep_size=2)
    engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=config, device="cpu")
    born = state(engine)
    ep_rank = engine.topology.get_axis_rank("ep")
    groups.reset()
    whole = MixtralForCausalLM.from_seed(mix, SEED, device="cpu", ep_size=2, ep_rank=ep_rank)
    ref, *_ = deepspeed_tpu_torch.initialize(model=whole, config=config, device="cpu")
    out["zero_init_ep"] = dict(
        differs=[k for k, t in state(ref).items() if not torch.equal(t, born[k])],
        experts=sum(leaf.place.expert for leaf in engine._leaves), ep_rank=ep_rank)


def llama_engine(inp, stage, lr=1e-2, **zero):
    groups.reset()
    config = {"train_batch_size": 8, "train_micro_batch_size_per_gpu": 1,
              "gradient_accumulation_steps": 2,
              "optimizer": {"type": "AdamW", "params": {"lr": lr}},
              "zero_optimization": dict({"stage": stage,
                                         "stage3_param_persistence_threshold": 0}, **zero)}
    model = LlamaForCausalLM(LlamaConfig.tiny(dtype=torch.float32), device="cpu")
    engine, *_ = deepspeed_tpu_torch.initialize(model=model, model_parameters=inp["llama"],
                                                config=config, device="cpu")
    return engine


def mine(batch, rank):
    return {k: v[rank:rank + 1] for k, v in batch.items()}


def fragment_runs(inp, rank, out):
    key = "layers.0.mlp.gate_proj.weight"
    for stage in (0, 1, 3):
        engine = llama_engine(inp, stage, lr=inp["fragment_lr"])
        for b in inp["batches"][:4]:
            loss = engine(mine(b, rank))
            engine.backward(loss)
            engine.step()
        loss = engine(mine(inp["batches"][4], rank))
        engine.backward(loss)               # mid-window: the accumulators hold it
        res = {n: dict(param=tf.safe_get_full_fp32_param(engine, n),
                       exp_avg=tf.safe_get_full_optimizer_state(engine, n, "exp_avg"),
                       exp_avg_sq=tf.safe_get_full_optimizer_state(engine, n, "exp_avg_sq"),
                       grad=tf.safe_get_full_grad(engine, n))
               for n in tf.param_names(engine)}
        leaf = next(x for x in engine._leaves if x.name == key)
        local = tf.safe_get_local_fp32_param(engine, key)
        new = torch.arange(leaf.param.numel(), dtype=torch.float32).reshape(leaf.shape)
        assert tf.safe_set_full_fp32_param(engine, key, new)
        assert tf.safe_set_full_optimizer_state(engine, key, new * 2, "exp_avg")
        out[f"fragments_{stage}"] = dict(
            full=res, local_numel=local.numel(),
            local_grad_numel=tf.safe_get_local_grad(engine, key).numel(),
            local_state_numel=tf.safe_get_local_optimizer_state(engine, key,
                                                                "exp_avg").numel(),
            set_param=tf.safe_get_full_fp32_param(engine, key),
            set_local=tf.safe_get_local_fp32_param(engine, key),
            set_state=tf.safe_get_full_optimizer_state(engine, key, "exp_avg"),
            master_dim=leaf.master_dim, unknown=tf.safe_get_full_fp32_param(engine, "nope"),
            absent_state=tf.safe_get_full_optimizer_state(engine, key, "trace"))


# (shape, the world's exchange dim, the dp group's dim): the dp chunk made
# of whole world chunks, and cut along another dim than theirs
MICS_SHAPES = (((8, 6), 0, 0), ((6, 8), 1, 1), ((4, 6), 0, 1), ((3, 4, 6), 1, 2))


def mics_redistribution(plan):
    """``QgzPlan.shard_group_chunk`` on a tensor every rank knows: this
    rank's world chunk in, its dp chunk out, against ``shard_of``."""
    from deepspeed_tpu_torch.runtime.zero.partition import shard_of, zero_shard_dim
    res = []
    for shape, d, e in MICS_SHAPES:
        assert (zero_shard_dim(shape, plan.world), zero_shard_dim(shape, 2)) == (d, e)
        x = torch.arange(float(torch.Size(shape).numel())).view(shape)
        got = plan.shard_group_chunk(shard_of(x, d, plan.world, plan.world_index).clone(),
                                     shape, d, e, 2)
        res.append(torch.equal(got, shard_of(x, e, 2, plan.dp_index)))
    return res


def qgz_mics_runs(inp, rank, out):
    from deepspeed_tpu_torch.runtime.comm import coalesced_collectives as cc
    for name, zero in (("qgz_mics", dict(mics_shard_size=2, zero_quantized_gradients=True)),
                       ("mics", dict(mics_shard_size=2)),
                       ("qgz_hpz", dict(zero_hpz_partition_size=2,
                                        zero_quantized_gradients=True))):
        engine = llama_engine(inp, 2, **zero)
        cc.reset_wire_bytes()
        losses = []
        for b in inp["batches"][:4]:
            loss = engine(mine(b, rank))
            engine.backward(loss)
            engine.step()
            losses.append(float(loss.detach()))
        out[name] = dict(losses=losses, masters=engine.get_model_parameters(),
                         hierarchy=engine.topology.zero_hierarchy,
                         zero_world=engine.partitioner.zero_world,
                         wire={op: dict(v) for op, v in cc.WIRE_BYTES["ops"].items()},
                         grad_bytes=sum(leaf.acc.numel() * 4 for leaf in engine._leaves))
        if name == "qgz_mics":
            out[name]["redistributed"] = mics_redistribution(engine._qgz)


def main():
    rank, world, init_file, inputs, out_path = sys.argv[1:6]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    tdist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                             world_size=world, timeout=datetime.timedelta(seconds=120))
    inp = torch.load(inputs, weights_only=False)
    out, seconds = {}, {}
    for name, run in (("zero_init", zero_init_runs), ("fragments", fragment_runs),
                      ("qgz_mics", qgz_mics_runs)):
        t = time.perf_counter()
        run(inp, rank, out)
        seconds[name] = time.perf_counter() - t
    print(f"rank {rank} seconds {seconds}", flush=True)
    torch.save(out, out_path)
    tdist.barrier()
    tdist.destroy_process_group()


if __name__ == "__main__":
    main()
