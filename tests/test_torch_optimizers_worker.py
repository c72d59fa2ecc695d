"""One rank of the 4-process gloo runs of ``tests/test_torch_optimizers.py``.

``python tests/test_torch_optimizers_worker.py RANK WORLD INIT_FILE INPUTS OUT``
joins a gloo process group through ``file://INIT_FILE`` and, on the inputs
``torch.load(INPUTS)`` gives:

- for each (optimizer, ZeRO stage) case, builds the tiny Llama's engine at
  that stage over the 4 ranks, feeds each step's whole gradients to this
  rank's master pieces, steps the optimizer, and keeps the gathered masters;
- runs ``compressed_allreduce`` on this rank's row of each step's inputs,
  threading its error buffers.

It saves a dict of results to ``OUT``. It imports torch and the port only.
"""

import datetime
import os
import sys

import torch
import torch.distributed as tdist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import deepspeed_tpu_torch  # noqa: E402
from deepspeed_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM  # noqa: E402
from deepspeed_tpu_torch.ops.adam import set_lr  # noqa: E402
from deepspeed_tpu_torch.parallel import groups  # noqa: E402
from deepspeed_tpu_torch.runtime.comm import compressed  # noqa: E402
from deepspeed_tpu_torch.runtime.zero.partition import shard_of  # noqa: E402


def optimizer_case(inp, name, params, stage):
    groups.reset()
    config = {"train_batch_size": 4, "train_micro_batch_size_per_gpu": 1,
              "optimizer": {"type": name, "params": params},
              "zero_optimization": {"stage": stage,
                                    "stage3_param_persistence_threshold": 0}}
    model = LlamaForCausalLM(LlamaConfig.tiny(dtype=torch.float32), device="cpu")
    engine, *_ = deepspeed_tpu_torch.initialize(model=model, model_parameters=inp["params"],
                                                config=config, device="cpu")
    for grads, scale in zip(inp["grads"], inp["lr_scales"]):
        for leaf in engine._leaves:
            g = grads[leaf.name]
            if leaf.master_dim is not None:
                g = shard_of(g, leaf.master_dim, leaf.place.world, leaf.place.index).clone()
            leaf.master.grad = g.reshape(leaf.master.shape)
        set_lr(engine.optimizer, params["lr"] * scale)
        engine.optimizer.step()
    sharded = sum(leaf.master_dim is not None for leaf in engine._leaves)
    return engine.get_model_parameters(), sharded


def main():
    rank, world, init_file, inputs, out_path = sys.argv[1:6]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    tdist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                             world_size=world, timeout=datetime.timedelta(seconds=120))
    inp = torch.load(inputs, weights_only=False)
    out = {"optimizers": {}, "compressed": []}
    for name, params, stage in inp["cases"]:
        out["optimizers"][(name, stage)] = optimizer_case(inp, name, params, stage)
    we, se = compressed.init_error_buffers(inp["car_n"], world)
    for xs in inp["car_inputs"]:
        got, we, se = compressed.compressed_allreduce(xs[rank], we, se)
        out["compressed"].append((got, we.clone(), se.clone()))
    torch.save(out, out_path)
    tdist.barrier()
    tdist.destroy_process_group()


if __name__ == "__main__":
    main()
