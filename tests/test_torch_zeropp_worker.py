"""One rank of the 4-process gloo runs of ``tests/test_torch_zeropp.py``.

``python tests/test_torch_zeropp_worker.py RANK WORLD INIT_FILE INPUTS OUT``
joins a gloo process group through ``file://INIT_FILE``, runs every
port-side ZeRO++ and MiCS scenario on the inputs that
``torch.load(INPUTS)`` gives, and saves a dict of results to ``OUT``. It
imports torch and the port only; the test module runs the JAX side and
compares. Each part's seconds are printed to the rank's log.
"""

import datetime
import logging
import os
import sys
import time

import torch
import torch.distributed as tdist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import deepspeed_tpu_torch  # noqa: E402
from deepspeed_tpu_torch.comm import comm as dist  # noqa: E402
from deepspeed_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM  # noqa: E402
from deepspeed_tpu_torch.parallel import groups  # noqa: E402
from deepspeed_tpu_torch.parallel.topology import MeshTopology  # noqa: E402
from deepspeed_tpu_torch.runtime.comm import coalesced_collectives as cc  # noqa: E402
from deepspeed_tpu_torch.runtime.zero import mics, qwz  # noqa: E402
from deepspeed_tpu_torch.runtime.zero.partition import shard_of, zero_shard_dim  # noqa: E402
from deepspeed_tpu_torch.runtime.zero.qgz import QgzPlan  # noqa: E402
from test_torch_zero_worker import local_rows  # noqa: E402


def engine_run(model, params, config, batches, rank, rows, hook=None):
    """Train on this rank's rows of ``batches``: the engine, the losses and
    the collectives of the micro-steps and of the boundary steps by (op,
    ranks)."""
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=model, model_parameters=params, config=config, device="cpu")
    losses, micro, apply = [], {}, {}

    def add(into):
        for k, v in dist.collective_counts().items():
            into[k] = into.get(k, 0) + v
        dist.reset_collective_counts()

    for i, b in enumerate(batches):
        dist.reset_collective_counts()
        loss = engine(local_rows(b, rank, rows))
        engine.backward(loss)
        add(micro)
        engine.step()
        add(apply)
        losses.append(float(loss.detach()))
        if hook is not None:
            hook(engine, i)
    return engine, losses, {"micro": micro, "apply": apply}


def llama(inp):
    return LlamaForCausalLM(LlamaConfig(**inp["llama_dims"], dtype=torch.float32))


def working_copy(engine):
    """Per quantized leaf: this rank's int8 working chunk and the scales."""
    return {leaf.name: (leaf.shard.clone(), leaf.qscale.clone())
            for leaf in engine._leaves if leaf.quant}


def gathered(engine):
    """Every parameter as the stage-3 gather lays it out at use: the int8
    working copy all-gathered and dequantized (``_finish_gather``)."""
    with torch.no_grad():
        for u in range(len(engine._units)):
            engine._finish_unit(u)
        out = {leaf.name: leaf.param.data.clone() for leaf in engine._leaves}
        engine._release_all()
    return out


def engine_runs(inp, rank, out):
    rows = inp["micro"]
    for name, case in inp["engine_cases"].items():
        first = {}

        def hook(engine, i, first=first, name=name, fault=case.get("fault")):
            if engine.global_steps != 1 or first:
                return
            if name == "qwz":
                first.update(working=working_copy(engine), gathered=gathered(engine),
                             first_master=engine.get_model_parameters())
            if fault:
                first["planted"] = fault
                if rank == 0:
                    next(leaf for leaf in engine._leaves if leaf.name == fault).qscale.mul_(2)

        engine, losses, counts = engine_run(llama(inp), inp["llama_params"], case["config"],
                                            inp["llama_batches"], rank, rows, hook=hook)
        out[name] = dict(
            losses=losses, master=engine.get_model_parameters(), counts=counts,
            prefetch_depth=engine._prefetch_depth,
            buckets=None if engine._bucket_idxs is None else len(engine._bucket_idxs),
            quantized=sorted(leaf.name for leaf in engine._leaves if leaf.quant),
            hierarchy=engine.topology.zero_hierarchy,
            sizes=(engine.topology.dpr_size, engine.topology.dp_size),
            placement={leaf.name: (leaf.place.world, leaf.place.param_world,
                                   None if leaf.shard is None else leaf.shard.dtype)
                       for leaf in engine._leaves},
            wire={op: dict(v) for op, v in cc.WIRE_BYTES["ops"].items()},
            resident_after=sum(leaf.param.data.untyped_storage().nbytes() > 0
                               for leaf in engine._leaves if leaf.param_dim is not None),
            **first)
        cc.reset_wire_bytes()
        del engine
        groups.reset()


def checkpoint_run(inp, rank, out):
    """qwZ's checkpoint round trip: 2 steps, save; a fresh engine from other
    weights takes a step, loads the tag; its masters and int8 working copy
    against the saved engine's."""
    case = inp["engine_cases"]["qwz"]["config"]
    rows, batches = inp["micro"], inp["llama_batches"]
    save_dir = os.path.join(inp["ckpt_dir"], "qwz")
    gas = case["gradient_accumulation_steps"]
    engine, _, _ = engine_run(llama(inp), inp["llama_params"], case, batches[:2 * gas],
                              rank, rows)
    engine.save_checkpoint(save_dir, tag="t")
    before = engine.get_model_parameters()
    before_q = working_copy(engine)
    del engine
    groups.reset()
    torch.manual_seed(100 + rank)
    engine, _, _ = engine_run(llama(inp), None, case, batches[:gas], rank, rows)
    engine.load_checkpoint(save_dir, tag="t")
    out["qwz_checkpoint"] = dict(before=before, after=engine.get_model_parameters(),
                                 before_q=before_q, after_q=working_copy(engine))
    del engine
    groups.reset()


def collectives(inp, rank, world, out):
    res = {}
    topo = MeshTopology(dp=world, zero_shard_size=2, zero_hierarchy="hpz")
    dp_group, dpr_group = topo.get_group("dp"), topo.get_group("dpr")
    # the hierarchical topology and its constructors
    for name, t in (("hpz", topo), ("mics", MeshTopology(dp=world, zero_shard_size=2,
                                                         zero_hierarchy="mics")),
                    ("mics_topology", mics.mics_topology(2)),
                    ("hpz_topology", mics.hpz_topology(2))):
        res[f"topology_{name}"] = dict(
            sizes=(t.dpr_size, t.dp_size), hierarchy=t.zero_hierarchy,
            zero_axes=t.zero_axes, param_zero_axes=t.param_zero_axes,
            data_parallel_size=t.data_parallel_size,
            zero=t.axes_group(t.zero_axes)[1:], param=t.axes_group(t.param_zero_axes)[1:])
    # all_to_all_quant_reduce: one axis (dp, int8) and hierarchical
    g1 = torch.from_numpy(inp["a2a_single"][topo.get_axis_rank("dp")])
    res["a2a_single"] = cc.all_to_all_quant_reduce(g1, dp_group, intra_bits=8, group_size=32)
    g2 = torch.from_numpy(inp["a2a_hier"][topo.get_axis_rank("dpr"), topo.get_axis_rank("dp")])
    res["a2a_hier"] = cc.all_to_all_quant_reduce(g2, dp_group, dpr_group, intra_bits=4,
                                                 inter_bits=8, group_size=32)
    x = torch.from_numpy(inp["moe_blocks"][rank])
    res["moe_hier_a2a"] = cc.moe_hierarchical_a2a(x, dp_group, dpr_group, inter_bits=8,
                                                  group_size=64)
    # qwZ's working copy and hpZ's exchange on leaves the world cuts every way
    flat = MeshTopology(dp=world)
    fgroup = flat.axes_group(flat.zero_axes)[0]
    for name, (full, axis) in inp["qwz_leaves"].items():
        full = torch.from_numpy(full).to(torch.bfloat16)
        shape = tuple(full.shape)
        d = zero_shard_dim(shape, world)
        chunk = shard_of(full, d, world, rank)
        q, s = qwz.requantize_chunk(chunk, d, shape, fgroup, world, rank, axis=axis)
        qf, sf, wire = qwz.quantized_full(chunk, d, shape, fgroup, world, axis=axis)
        back = qwz.dequantize_leaf(qf, sf, torch.bfloat16, axis=axis)
        res[f"qwz_{name}"] = dict(dim=d, route=qwz.route(shape, d, world, axis=axis),
                                  q=q, scale=s, q_full=qf, scale_full=sf, hpz=back,
                                  wire=wire)
    # reduce(buckets=k) against buckets=1, with and without the residual
    plan = QgzPlan(topo)
    acc = [torch.from_numpy(a[rank]) for a in inp["bucket_leaves"]]
    res_in = [torch.from_numpy(a[rank]) * 1e-3 for a in inp["bucket_leaves"]]
    for k in (1, 3):
        cc.reset_wire_bytes()
        dist.reset_collective_counts()
        res[f"buckets_{k}"] = plan.reduce(acc, buckets=k)
        res[f"buckets_{k}_calls"] = sum(n for (op, _), n in dist.collective_counts().items()
                                        if op == "all_to_all")
        res[f"buckets_{k}_residual"] = plan.reduce(acc, residual=res_in,
                                                   return_residual=True, buckets=k)
        res[f"buckets_{k}_groups"] = plan.buckets_of(acc, k)
    out["collectives"] = res
    groups.reset()


def main():
    rank, world, init_file, inputs, out_path = sys.argv[1:6]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    logging.getLogger("deepspeed_tpu_torch").setLevel(logging.WARNING)
    tdist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                             world_size=world, timeout=datetime.timedelta(seconds=120))
    inp = torch.load(inputs, weights_only=False)
    out, seconds = {}, {}
    start = time.perf_counter()
    for name, run in (("collectives", lambda: collectives(inp, rank, world, out)),
                      ("engines", lambda: engine_runs(inp, rank, out)),
                      ("checkpoint", lambda: checkpoint_run(inp, rank, out))):
        t = time.perf_counter()
        run()
        seconds[name] = time.perf_counter() - t
    seconds["total"] = time.perf_counter() - start
    out["seconds"] = seconds
    print(f"rank {rank} seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()),
          flush=True)
    torch.save(out, out_path)
    tdist.barrier()
    tdist.destroy_process_group()


if __name__ == "__main__":
    main()
