"""One rank of the 4-process gloo runs of ``tests/test_torch_zero.py``.

``python tests/test_torch_zero_worker.py RANK WORLD INIT_FILE INPUTS OUT`` joins a
gloo process group through ``file://INIT_FILE``, runs every port-side
scenario on the inputs that ``torch.load(INPUTS)`` gives, and saves a dict
of results to ``OUT``. It imports torch and the port only; the test module
runs the JAX side and compares.
"""

import datetime
import os
import sys

import torch
import torch.distributed as tdist
from torch import nn

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import deepspeed_tpu_torch  # noqa: E402
from deepspeed_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM  # noqa: E402
from deepspeed_tpu_torch.parallel.topology import MeshTopology  # noqa: E402
from deepspeed_tpu_torch.runtime.comm import coalesced_collectives as cc  # noqa: E402
from deepspeed_tpu_torch.runtime.zero.qgz import QgzPlan  # noqa: E402

IGNORE = -100


class MaskedLM(nn.Module):
    """Embedding, one tanh layer and a head, with a cross entropy over the
    labels that are not IGNORE; its JAX twin is in the test module."""

    def __init__(self, vocab, dim):
        super().__init__()
        self.embed = nn.Parameter(torch.zeros(vocab, dim))
        self.w1 = nn.Parameter(torch.zeros(dim, dim))
        self.b1 = nn.Parameter(torch.zeros(dim))
        self.head = nn.Parameter(torch.zeros(dim, vocab))

    def forward(self, batch):
        x = self.embed[batch["input_ids"].long()]
        logits = torch.tanh(x @ self.w1 + self.b1) @ self.head
        labels = batch["labels"].long()
        mask = labels != IGNORE
        tgt = torch.gather(logits, -1, labels.clamp(min=0)[..., None])[..., 0]
        nll = torch.logsumexp(logits, -1) - tgt
        n = mask.sum()
        return (nll * mask).sum() / n.clamp(min=1), {"num_valid_tokens": n}


def local_rows(batch, rank, rows):
    return {k: v[rank * rows:(rank + 1) * rows] for k, v in batch.items()}


def train(model, params, config, batches, rank, rows, hook=None):
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=model, model_parameters=params, config=config, device="cpu")
    losses = []
    for i, b in enumerate(batches):
        loss = engine(local_rows(b, rank, rows))
        engine.backward(loss)
        engine.step()
        losses.append(float(loss.detach()))
        if hook is not None:
            hook(engine, i)
    return engine, losses


def at_rest(engine):
    """Per leaf: whole numel, the stage-3 working chunk's numel, whether the
    module's copy holds storage, and the master chunk's numel."""
    return {leaf.name: (leaf.param.numel(),
                        None if leaf.shard is None else leaf.shard.numel(),
                        leaf.param.data.untyped_storage().nbytes() > 0,
                        leaf.master.numel()) for leaf in engine._leaves}


def llama_runs(inp, rank, out):
    cfg, batches = inp["llama_config"], inp["llama_batches"]
    rows = inp["micro"]
    for name, extra in inp["llama_cases"].items():
        config = dict(cfg, **extra)
        trace = {}

        def hook(engine, i, trace=trace, name=name):
            if name == "qgz_feedback" and engine.was_step_applied():
                trace.setdefault("residual_norms", []).append(
                    float(sum(r.norm() ** 2 for r in engine._residual) ** 0.5))
                trace.setdefault("skipped_trace", []).append(engine.skipped_steps)

        model = LlamaForCausalLM(LlamaConfig.tiny(dtype=torch.float32))
        engine, losses = train(model, inp["llama_params"], config, batches, rank, rows,
                               hook=hook)
        res = dict(losses=losses, master=engine.get_model_parameters(),
                   skipped=engine.skipped_steps, scale=engine.cur_scale,
                   grad_norm=engine.get_global_grad_norm(), at_rest=at_rest(engine), **trace)
        out[name] = res


def masked_run(inp, rank, out):
    model = MaskedLM(*inp["masked_dims"])
    engine, losses = train(model, inp["masked_params"], inp["masked_config"],
                           inp["masked_batches"], rank, inp["micro"])
    out["masked"] = dict(losses=losses, master=engine.get_model_parameters())


def collectives(inp, rank, world, out):
    res = {}
    for bits in (4, 8):
        blocks = torch.from_numpy(inp["payload"][rank])
        got, err = cc.exchange_reduce(blocks, None, bits, 2048, return_error=True)
        res[f"exchange_{bits}"] = (got, err, cc.exchange_reduce(blocks, None, bits, 2048))
    res["all_gather"] = cc.quantized_all_gather(torch.from_numpy(inp["shard"][rank]))
    res["reduce_scatter"] = cc.reduce_scatter_coalesced(
        [torch.from_numpy(t[rank]) for t in inp["coalesced"]])
    for name, mesh_kw in (("dp", {}), ("hpz", dict(zero_shard_size=2, zero_hierarchy="hpz"))):
        topo = MeshTopology(dp=world, **mesh_kw)
        res[f"topology_{name}"] = dict(
            coord=topo.get_coord(rank), rank=topo.get_rank(**topo.get_coord(rank)),
            zero=topo.axes_group(topo.zero_axes)[1:],
            param=topo.axes_group(topo.param_zero_axes)[1:],
            dp_group=tdist.get_process_group_ranks(topo.get_group("dp"))
            if topo.get_group("dp") is not None else None)
        plan = QgzPlan(topo)
        local = torch.from_numpy(inp["stacked"][rank])
        d, axes = plan._zero_dim(local.shape)
        res[f"reduce_leaf_{name}"] = (d, axes, plan._reduce_leaf(local, d, axes),
                                      plan._reduce_leaf(local, d, axes, want_error=True))
    out["collectives"] = res


def main():
    rank, world, init_file, inputs, out_path = sys.argv[1:6]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    tdist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                             world_size=world, timeout=datetime.timedelta(seconds=120))
    inp = torch.load(inputs, weights_only=False)
    out = {}
    collectives(inp, rank, world, out)
    llama_runs(inp, rank, out)
    masked_run(inp, rank, out)
    torch.save(out, out_path)
    tdist.barrier()
    tdist.destroy_process_group()


if __name__ == "__main__":
    main()
