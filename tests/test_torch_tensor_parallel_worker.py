"""One rank of the gloo runs of ``tests/test_torch_tensor_parallel.py``.

``python tests/test_torch_tensor_parallel_worker.py SUITE RANK WORLD INIT_FILE
INPUTS OUT`` joins a gloo process group of WORLD ranks through
``file://INIT_FILE``, runs the scenarios of SUITE ("tp2": tensor-parallel
serving on 2 ranks; "grid4": the (dp, tp) grid and the topology on 4) on the
inputs that ``torch.load(INPUTS)`` gives, and saves a dict of results to
OUT. It imports torch and the port only; the test module runs the JAX side
and compares.
"""

import dataclasses
import datetime
import os
import sys
import time
import traceback

import numpy as np
import torch
import torch.distributed as tdist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import deepspeed_tpu_torch  # noqa: E402
from deepspeed_tpu_torch.inference.v2 import (SplitFuseScheduler,  # noqa: E402
                                              build_engine, scheduler)
from deepspeed_tpu_torch.inference.v2.engine_factory import build_replica  # noqa: E402
from deepspeed_tpu_torch.inference.v2.fleet import PrefillDecodeFleet  # noqa: E402
from deepspeed_tpu_torch.inference.v2.replica_group import ReplicaGroup  # noqa: E402
from deepspeed_tpu_torch.models import llama as port_llama  # noqa: E402
from deepspeed_tpu_torch.models import mixtral as port_mixtral  # noqa: E402
from deepspeed_tpu_torch.models.opt import OPTConfig, OPTForCausalLM  # noqa: E402
from deepspeed_tpu_torch.models.falcon import tiny_falcon_config  # noqa: E402
from deepspeed_tpu_torch.models.parallel_block import ParallelBlockForCausalLM  # noqa: E402
from deepspeed_tpu_torch.parallel import groups  # noqa: E402
from deepspeed_tpu_torch.parallel import tensor_parallel as tpl  # noqa: E402
from deepspeed_tpu_torch.parallel.topology import MeshTopology  # noqa: E402

CPU = "cpu"


def llama_model(inp, **cfg):
    model = port_llama.LlamaForCausalLM(port_llama.LlamaConfig.tiny(dtype=torch.float32,
                                                                    **cfg))
    model.load_state_dict(port_llama.params_from_flax(inp["llama_params"]))
    return model.requires_grad_(False)


def mixtral_model(inp):
    model = port_mixtral.MixtralForCausalLM(
        port_mixtral.MixtralConfig.tiny(dtype=torch.float32, remat=False))
    model.load_state_dict(port_mixtral.params_from_flax(inp["mixtral_params"]))
    return model.requires_grad_(False)


def engine_config(tp_size, kv_dtype="fp", **extra):
    cfg = dict(inp_engine_config(), tensor_parallel={"tp_size": tp_size})
    cfg["state_manager"] = dict(cfg["state_manager"], kv_dtype=kv_dtype)
    cfg.update(extra)
    return cfg


def inp_engine_config():
    return {"state_manager": {"max_ragged_sequence_count": 9, "max_ragged_batch_size": 64,
                              "max_context": 96, "num_kv_blocks": 96},
            "kv_cache": {"block_size": 8, "cache_dtype": "fp32"}}


def serve_rounds(engine, rounds):
    """``put`` every round of ``rounds`` (lists of (uid, tokens)); the
    controller returns each round's logits, a follower its forward count."""
    if not engine.is_controller:
        return engine.follow()
    out = []
    for batch in rounds:
        out.append(engine.put([u for u, _ in batch],
                              [np.asarray(t, np.int32) for _, t in batch]))
    engine.stop_followers()
    return out


def swap_layer0_q_shard(model, whole, rank):
    """Planted fault: rank 1 holds rank 0's slice of layer 0's q_proj."""
    if rank == 1:
        w = whole.layers[0].self_attn.q_proj.weight
        model.layers[0].self_attn.q_proj.weight.copy_(w[:w.shape[0] // 2])


def v2_runs(inp, rank, out):
    """The v2 engine at tp 2 on the one pre-drawn token stream, Llama (fp
    and int8 KV pools) and Mixtral, the planted fault, the follower's state."""
    llama, mixtral = llama_model(inp), mixtral_model(inp)
    for name, model, kv_dtype in (("llama", llama, "fp"), ("llama_int8", llama, "int8"),
                                  ("mixtral", mixtral, "fp")):
        engine = build_engine(model, engine_config(2, kv_dtype), device=CPU)
        tpl.reset_counts()
        out[f"v2_{name}"] = serve_rounds(engine, inp["rounds"])
        out[f"v2_{name}_counts"] = tpl.counts()
        out[f"v2_{name}_tracked"] = engine._state.n_tracked_sequences
        out[f"v2_{name}_attention"] = engine.attention_impl
    engine = build_engine(llama, engine_config(2), device=CPU)
    swap_layer0_q_shard(engine._model, llama, rank)
    out["v2_fault"] = serve_rounds(engine, inp["rounds"][:1])


def sampled_runs(inp, rank, out):
    """Sampled requests through ``build_replica`` at tp 2 against a tp 1
    engine on this rank alone; then again with rank 1's scheduler clock
    skewed and SLO classes on (whose burn rates read the clock)."""
    llama = llama_model(inp)

    def serve(sched):
        for uid, prompt, seed in inp["sampled"]:
            sched.submit(uid, np.asarray(prompt, np.int32), max_new_tokens=6,
                         temperature=1.0, top_k=20, seed=seed)
        sched.run_to_completion()
        sched.engine.stop_followers()
        return {u: list(map(int, t)) for u, t in sched.results().items()}

    alone = build_engine(llama, engine_config(1), device=CPU)
    out["sampled_tp1"] = serve(SplitFuseScheduler(alone, token_budget=24))
    tp, sched = build_replica(llama, tp_size=2, engine_config=engine_config(1),
                              token_budget=24, device=CPU)
    out["sampled_tp2"] = serve(sched) if sched is not None else None
    out["replica_tp"] = (tp.size, tp.rank)
    slo = {"slo_classes": {"interactive": {"ttft_target_s": 1e-9, "tpot_target_s": 1e-9}}}
    real_now = scheduler._now
    if rank == 1:
        scheduler._now = lambda: real_now() * 1000.0 + 1e6
    try:
        _, sched = build_replica(llama, tp_size=2, engine_config=engine_config(1, **slo),
                                 token_budget=24, device=CPU)
        out["skewed_tp2"] = serve(sched) if sched is not None else None
    finally:
        scheduler._now = real_now


def preemption_runs(inp, rank, out):
    """``tests/test_torch_serving.py``'s KV pressure (10 blocks of 8 tokens
    for two 44-token prompts and 6 new tokens each) at tp 2: the controller
    swaps a sequence out and back, the follower copies its shards of the
    same pages, and the greedy streams equal the pressured tp 1 run's."""
    llama = llama_model(inp)
    prompts = inp["pressure"]

    def run(tp_size):
        cfg = engine_config(tp_size)
        cfg["state_manager"] = dict(cfg["state_manager"], max_ragged_sequence_count=4,
                                    max_ragged_batch_size=16, num_kv_blocks=10)
        engine = build_engine(llama, cfg, device=CPU)
        if not engine.is_controller:
            engine.follow()
            return None, None
        sched = SplitFuseScheduler(engine, token_budget=16)
        for uid, p in enumerate(prompts):
            sched.submit(uid, np.asarray(p, np.int32), max_new_tokens=6)
        streams = {u: list(map(int, t)) for u, t in sched.run_to_completion().items()}
        engine.stop_followers()
        return streams, engine.swap_stats

    out["pressure_tp1"], _ = run(1)
    out["pressure_tp2"], out["pressure_swaps"] = run(2)


def v1_runs(inp, rank, out, tp_size, replica_num, key):
    """``init_inference`` over the grid: logits of ``ids``, this rank's
    weights, greedy and sampled ``generate``."""
    eng = deepspeed_tpu_torch.init_inference(
        llama_model(inp), config={"dtype": "fp32", "tensor_parallel": {"tp_size": tp_size},
                                  "replica_num": replica_num}, device=CPU)
    out[f"{key}_grid"] = eng.grid
    out[f"{key}_installed"] = eng.topology is groups.get_topology()
    out[f"{key}_logits"] = eng(inp["v1_ids"]).numpy()
    out[f"{key}_state"] = {k: v.clone() for k, v in eng.module.state_dict().items()}
    out[f"{key}_greedy"] = eng.generate(inp["v1_ids"], max_new_tokens=6).numpy()
    out[f"{key}_sampled"] = eng.generate(inp["v1_ids"], max_new_tokens=6, temperature=1.0,
                                         top_k=20, rng=123).numpy()


def raised(fn):
    try:
        fn()
    except Exception as e:  # the test reads which error, and its message
        return f"{type(e).__name__}: {e}"
    return None


def stopped(replicas):
    """A tp group of replicas (fleet or ``ReplicaGroup``) built on every
    rank: the controller ends the followers' loops at once."""
    replicas.stop_followers()


def refusals(inp, out):
    """What tensor-parallel serving refused at tp 2 and serves now (each
    case builds, the text None), and what it refuses: the errors' texts."""
    ecfg = engine_config(2)

    def tiny(**kw):
        return dataclasses.replace(port_llama.LlamaConfig.tiny(), head_dim=None, **kw)

    def seeded(cfg, cls=port_llama.LlamaForCausalLM):
        return cls.from_seed(cfg, seed=0, device=CPU)

    cases = {
        "opt": lambda: build_engine(seeded(OPTConfig.tiny(dtype=torch.float32),
                                           OPTForCausalLM), ecfg, device=CPU),
        "falcon": lambda: build_engine(seeded(tiny_falcon_config(dtype=torch.float32),
                                              ParallelBlockForCausalLM), ecfg, device=CPU),
        "kv_heads": lambda: build_engine(seeded(tiny(dtype=torch.float32,
                                                     num_key_value_heads=1)), ecfg,
                                         device=CPU),
        "heads": lambda: build_engine(seeded(tiny(dtype=torch.float32, hidden_size=96,
                                                  num_attention_heads=3,
                                                  num_key_value_heads=3)), ecfg, device=CPU),
        "vocab": lambda: build_engine(seeded(tiny(dtype=torch.float32, vocab_size=511)),
                                      ecfg, device=CPU),
        "v1_quant": lambda: deepspeed_tpu_torch.init_inference(
            llama_model(inp), config={"dtype": "fp32", "tensor_parallel": {"tp_size": 2},
                                      "quant": {"enabled": True, "group_size": 16}},
            device=CPU),
        "speculative": lambda: build_engine(
            llama_model(inp), engine_config(2, speculative={"enabled": True}), device=CPU),
        "host_tier": lambda: build_engine(llama_model(inp), dict(
            ecfg, prefix_caching=True, state_manager=dict(ecfg["state_manager"],
                                                          host_kv_blocks=4)), device=CPU),
        "v1_labels": lambda: deepspeed_tpu_torch.init_inference(
            llama_model(inp), config={"dtype": "fp32", "tensor_parallel": {"tp_size": 2}},
            device=CPU)({"input_ids": inp["v1_ids"], "labels": inp["v1_ids"]}),
        "train_config": lambda: deepspeed_tpu_torch.initialize(
            model=seeded(tiny(dtype=torch.float32)),
            config={"train_batch_size": 2, "tensor_parallel": {"tp_size": 2}}, device=CPU),
        "train_mesh": lambda: deepspeed_tpu_torch.initialize(
            model=seeded(tiny(dtype=torch.float32)), config={"train_batch_size": 2},
            mesh=MeshTopology(tp=2), device=CPU),
        "fleet": lambda: stopped(PrefillDecodeFleet(llama_model(inp), devices=[CPU] * 4,
                                                    tp_size=2,
                                                    engine_config=inp_engine_config())),
        "replica_group": lambda: stopped(ReplicaGroup(llama_model(inp), [CPU, CPU],
                                                      tp_size=2)),
        "ep_with_tp": lambda: port_mixtral.MixtralForCausalLM(
            port_mixtral.MixtralConfig.tiny(), device="meta", ep_size=2, tp_size=2),
    }
    out["refusals"] = {name: raised(fn) for name, fn in cases.items()}
    groups.reset()


def topology_runs(inp, rank, world, out):
    """The tp cases of ``tests/test_topology.py`` with pp 1, on the ranks;
    then serving at another tp over the installed topology, which must
    raise and leave it installed."""
    t = MeshTopology(tp=2)
    res = {"sizes": (t.dp_size, t.tp_size, t.data_parallel_size),
           "roundtrip": all(t.get_rank(**t.get_coord(r)) == r for r in range(world))}
    res["indivisible"] = raised(lambda: MeshTopology(tp=3))
    groups.initialize(mesh_topology=MeshTopology(dp=2, tp=2))
    res["registry"] = (groups.get_tensor_model_parallel_world_size(),
                       groups.get_tensor_model_parallel_rank(),
                       groups.get_model_parallel_world_size(),
                       groups.get_data_parallel_world_size())
    member = torch.tensor([float(rank)])
    tdist.all_reduce(member, group=groups.get_tensor_model_parallel_group())
    res["tp_group_rank_sum"] = float(member)
    tp = groups.get_tensor_parallel()
    res["tensor_parallel"] = (tp.size, tp.rank, tp.ranks)
    installed = groups.get_topology()
    res["other_tp_v2"] = raised(lambda: build_engine(llama_model(inp), engine_config(4),
                                                     device=CPU))
    res["other_tp_v1"] = raised(lambda: deepspeed_tpu_torch.init_inference(
        llama_model(inp), config={"dtype": "fp32", "tensor_parallel": {"tp_size": 4}},
        device=CPU))
    res["kept"] = groups.get_topology() is installed
    groups.reset()
    out["topology"] = res


def idle_grid_runs(inp, out):
    """A (1, 2) grid in the world of 4 leaves two ranks idle: they hold no
    weights and return rank 0's logits."""
    groups.reset()
    eng = deepspeed_tpu_torch.init_inference(
        llama_model(inp), config={"dtype": "fp32", "tensor_parallel": {"tp_size": 2}},
        device=CPU)
    out["idle_grid"] = (eng.grid, eng.idle, eng(inp["v1_ids"]).numpy())
    groups.reset()


def clamp_runs(inp, out):
    """``tp_size`` 4 and ``replica_num`` 64 on 4 ranks (a model whose 4 KV
    heads 4 ranks divide), against the same model served alone. The (2, 2)
    grid the scenario before installed is uninstalled first: a serving
    engine never replaces an installed topology."""
    groups.reset()
    cfg = dataclasses.replace(port_llama.LlamaConfig.tiny(dtype=torch.float32),
                              num_key_value_heads=4)
    model = port_llama.LlamaForCausalLM.from_seed(cfg, seed=3, device=CPU)
    alone = model(torch.as_tensor(inp["v1_ids"]).long())
    eng = deepspeed_tpu_torch.init_inference(
        model, config={"dtype": "fp32", "tensor_parallel": {"tp_size": 4},
                       "replica_num": 64}, device=CPU)
    out["clamp_grid"] = eng.grid
    out["clamp_logits"] = eng(inp["v1_ids"]).numpy()
    out["clamp_alone"] = alone.numpy()


SUITES = {
    "tp2": lambda inp, rank, world, out: [
        v1_runs(inp, rank, out, 2, 1, "v1_tp2"), v2_runs(inp, rank, out),
        sampled_runs(inp, rank, out), preemption_runs(inp, rank, out),
        refusals(inp, out)],
    "grid4": lambda inp, rank, world, out: [
        v1_runs(inp, rank, out, 2, 2, "v1_dp2tp2"), clamp_runs(inp, out),
        idle_grid_runs(inp, out), topology_runs(inp, rank, world, out)],
}


def main():
    suite, rank, world, init_file, inputs, out_path = sys.argv[1:7]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    tdist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                             world_size=world, timeout=datetime.timedelta(seconds=120))
    inp = torch.load(inputs, weights_only=False)
    out = {}
    start = time.perf_counter()
    try:
        with torch.no_grad():
            SUITES[suite](inp, rank, world, out)
    except Exception:
        traceback.print_exc()
        raise
    print(f"rank {rank} of {suite}: {time.perf_counter() - start:.1f}s", flush=True)
    torch.save(out, out_path)
    tdist.barrier()
    tdist.destroy_process_group()


if __name__ == "__main__":
    main()
