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
import time

import torch
import torch.distributed as tdist
from torch import nn

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import deepspeed_tpu_torch  # noqa: E402
from deepspeed_tpu_torch.comm.comm import get_world_size  # noqa: E402
from deepspeed_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM  # noqa: E402
from deepspeed_tpu_torch.models.mixtral import (MixtralConfig,  # noqa: E402
                                                MixtralExpertMLP, MixtralForCausalLM,
                                                params_from_flax)
from deepspeed_tpu_torch.moe import sharded_moe as pmoe  # noqa: E402
from deepspeed_tpu_torch.moe.utils import expert_slice  # noqa: E402
from deepspeed_tpu_torch.parallel import groups  # noqa: E402
from deepspeed_tpu_torch.parallel.topology import MeshTopology  # noqa: E402
from deepspeed_tpu_torch.runtime.comm import coalesced_collectives as cc  # noqa: E402
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig  # noqa: E402
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


def moe_engine_runs(inp, rank, out):
    """Mixtral engines, expert-parallel or not: losses, whole masters, the
    clipping norm and each leaf's layout at rest."""
    for name, case in inp["moe_cases"].items():
        ep = case["ep"]
        cfg = MixtralConfig(**case["model"], dtype=torch.float32)
        params = params_from_flax(inp["moe_params"][case["params"]], ep, rank % ep)
        engine, losses = train(MixtralForCausalLM(cfg, ep_size=ep), params, case["config"],
                               inp["moe_batches"], rank, inp["micro"])
        out[name] = dict(losses=losses, master=engine.get_model_parameters(),
                         grad_norm=engine.get_global_grad_norm(), at_rest=at_rest(engine),
                         local_shapes={leaf.name: leaf.shape for leaf in engine._leaves})
        del engine
        groups.reset()
    cfg = MixtralConfig(**next(iter(inp["moe_cases"].values()))["model"],
                        dtype=torch.float32)
    try:
        deepspeed_tpu_torch.initialize(
            model=MixtralForCausalLM(cfg, ep_size=2), device="cpu",
            config=dict(inp["llama_config"], expert_parallel_size=2, zero_optimization={
                "stage": 2, "zero_quantized_gradients": True}))
    except ValueError as e:
        out["qgz_ep_error"] = str(e)
    groups.reset()


def moe_layer_runs(inp, rank, world, out):
    """One MOELayer per (ep mesh, case): this rank's output, aux loss, counts
    and gradients of ``sum(out * dout) + 0.1 * l_aux / world`` (the ranks'
    gradients sum to the global loss's), and the quantized wire's forward."""
    D, F, E = inp["layer_dims"]
    x_all, dout_all = (torch.from_numpy(a).reshape(-1, D) for a in inp["layer_inputs"])
    n = x_all.shape[0] // world
    x_loc, dout_loc = x_all[rank * n:(rank + 1) * n], dout_all[rank * n:(rank + 1) * n]
    expert = lambda: MixtralExpertMLP(MixtralConfig(hidden_size=D, intermediate_size=F,
                                                    dtype=torch.float32))
    res = {}
    for ep in (2, 4):
        # the ep axis from groups.initialize, the config naming none
        topo = groups.initialize(ep_size=ep, config=DeepSpeedConfig(inp["llama_config"]))
        ep_rank = topo.get_axis_rank("ep")
        res[(ep, "topology")] = (topo.ep_size, topo.dp_size, ep_rank,
                                 get_world_size(groups.get_expert_parallel_group()),
                                 groups.get_expert_data_parallel_world_size())
        for name, (k, cf, drop, mode) in inp["layer_cases"].items():
            p = inp["layer_params"][name]
            layer = pmoe.MOELayer(expert, E, k, cf, cf, min_capacity=2, drop_tokens=drop,
                                  dispatch_mode=mode, model_dim=D, ep_size=ep)
            layer.load_state_dict({"gate.wg": torch.from_numpy(p["wg"])} | {
                f"experts.{w}": torch.from_numpy(expert_slice(p[w], ep, ep_rank))
                for w in ("w1", "w2", "w3")})
            x = x_loc.clone().requires_grad_()
            y, l_aux, counts = layer(x)
            ((y * dout_loc).sum() + 0.1 * l_aux / world).backward()
            res[(ep, name)] = dict(
                out=y.detach(), l_aux=float(l_aux.detach()), counts=counts, dx=x.grad,
                wg=layer.gate.wg.grad, ep_rank=ep_rank,
                **{w: getattr(layer.experts, w).grad for w in ("w1", "w2", "w3")})
        # the quantized wire: the gmm dropless case's forward with int8 blocks
        p = inp["layer_params"]["gmm_top2_dropless"]
        outs = {}
        for bits in (None, 8):
            layer = pmoe.MOELayer(expert, E, 2, drop_tokens=False, dispatch_mode="gmm",
                                  model_dim=D, ep_size=ep, a2a_wire_bits=bits)
            layer.load_state_dict({"gate.wg": torch.from_numpy(p["wg"])} | {
                f"experts.{w}": torch.from_numpy(expert_slice(p[w], ep, ep_rank))
                for w in ("w1", "w2", "w3")})
            cc.reset_wire_bytes()
            with torch.no_grad():
                outs[bits] = layer(x_loc)[0]
            outs[f"wire_{bits}"] = {op: dict(v) for op, v in cc.WIRE_BYTES["ops"].items()}
        res[(ep, "wire")] = outs
        groups.reset()
    out["moe_layers"] = res


def resume_runs(inp, rank, out):
    """Each resume case's engine again, interrupted: the first half of its
    micro-batches, ``save_checkpoint`` into a directory the ranks share, a
    fresh engine from other initial weights that ``load_checkpoint``s the
    tag, the second half. The losses of both halves and the whole masters
    at the end, which the test holds to the uninterrupted run of the same
    case (run by ``llama_runs`` / ``moe_engine_runs``)."""
    res = {}
    for name, (family, case) in inp["resume_cases"].items():
        if family == "llama":
            config = dict(inp["llama_config"], **inp["llama_cases"][case])
            batches, params = inp["llama_batches"], inp["llama_params"]

            def make():
                return LlamaForCausalLM(LlamaConfig.tiny(dtype=torch.float32))
        else:
            c = inp["moe_cases"][case]
            config, batches, ep = c["config"], inp["moe_batches"], c["ep"]
            params = params_from_flax(inp["moe_params"][c["params"]], ep, rank % ep)

            def make(c=c, ep=ep):
                return MixtralForCausalLM(MixtralConfig(**c["model"], dtype=torch.float32),
                                          ep_size=ep)
        half = len(batches) // 2
        save_dir = os.path.join(inp["ckpt_dir"], name)
        engine, losses = train(make(), params, config, batches[:half], rank, inp["micro"])
        path = engine.save_checkpoint(save_dir)
        del engine
        groups.reset()
        torch.manual_seed(1000 + rank)
        engine, *_ = deepspeed_tpu_torch.initialize(model=make(), config=config, device="cpu")
        loaded, _ = engine.load_checkpoint(save_dir)
        for b in batches[half:]:
            loss = engine(local_rows(b, rank, inp["micro"]))
            engine.backward(loss)
            engine.step()
            losses.append(float(loss.detach()))
        res[name] = dict(losses=losses, master=engine.get_model_parameters(),
                         saved=path, loaded=loaded, steps=engine.global_steps)
        del engine
        groups.reset()
    out["resume"] = res


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
        d = plan._zero_dim(local.shape)
        res[f"reduce_leaf_{name}"] = (d, plan.axes, plan._reduce_leaf(local, d),
                                      plan._reduce_leaf(local, d, want_error=True))
    out["collectives"] = res


def main():
    rank, world, init_file, inputs, out_path = sys.argv[1:6]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    tdist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                             world_size=world, timeout=datetime.timedelta(seconds=120))
    inp = torch.load(inputs, weights_only=False)
    out, seconds = {}, {}
    start = time.perf_counter()
    for name, run in (("collectives", lambda: collectives(inp, rank, world, out)),
                      ("moe_layers", lambda: moe_layer_runs(inp, rank, world, out)),
                      ("moe_engines", lambda: moe_engine_runs(inp, rank, out)),
                      ("llama", lambda: llama_runs(inp, rank, out)),
                      ("masked", lambda: masked_run(inp, rank, out)),
                      ("resume", lambda: resume_runs(inp, rank, out))):
        t = time.perf_counter()
        run()
        seconds[name] = time.perf_counter() - t
    # wall time of each part after the rendezvous: the fixture's limit
    # holds the whole run
    seconds["total"] = time.perf_counter() - start
    out["seconds"] = seconds
    print(f"rank {rank} seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()),
          flush=True)
    torch.save(out, out_path)
    tdist.barrier()
    tdist.destroy_process_group()


if __name__ == "__main__":
    main()
