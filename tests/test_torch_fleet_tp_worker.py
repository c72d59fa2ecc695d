"""One rank of the gloo runs of ``tests/test_torch_fleet_tp.py``.

``python tests/test_torch_fleet_tp_worker.py SUITE RANK WORLD INIT_FILE INPUTS
OUT`` joins a gloo process group of WORLD ranks through ``file://INIT_FILE``,
runs the scenarios of SUITE ("w3": tp-2 replicas in a ``ReplicaGroup`` and a
``PrefillDecodeFleet``, idle v1 ranks and an HF directory quantized at tp,
on 3 ranks; "w4": empty ``TPPlan`` shares at tp 4) on the inputs that
``torch.load(INPUTS)`` gives, and saves a dict of results to OUT. It imports
torch and the port only; the test module runs the JAX side and compares.
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
from deepspeed_tpu_torch.checkpoint import hf  # noqa: E402
from deepspeed_tpu_torch.inference.v2 import build_engine  # noqa: E402
from deepspeed_tpu_torch.inference.v2.fleet import PrefillDecodeFleet  # noqa: E402
from deepspeed_tpu_torch.inference.v2.replica_group import ReplicaGroup  # noqa: E402
from deepspeed_tpu_torch.models import llama as port_llama  # noqa: E402
from deepspeed_tpu_torch.parallel import groups  # noqa: E402
from deepspeed_tpu_torch.parallel.tensor_parallel import TPPlan  # noqa: E402

CPU = "cpu"
ENG = {"state_manager": {"max_ragged_sequence_count": 9, "max_ragged_batch_size": 64,
                         "max_context": 96, "num_kv_blocks": 96},
       "kv_cache": {"block_size": 8, "cache_dtype": "fp32"}}


def eng_config(kv_dtype="fp"):
    return dict(ENG, state_manager=dict(ENG["state_manager"], kv_dtype=kv_dtype))


def llama_model(params, **cfg):
    """The tiny Llama (``cfg`` replaces fields of it) with the flax weights."""
    config = port_llama.LlamaConfig.tiny(dtype=torch.float32)
    if cfg:
        config = dataclasses.replace(config, head_dim=None, **cfg)
    model = port_llama.LlamaForCausalLM(config)
    model.load_state_dict(port_llama.params_from_flax(params))
    return model.requires_grad_(False)


def put(engine, batch):
    return engine.put([u for u, _ in batch], [np.asarray(t, np.int32) for _, t in batch])


def fleet_rounds(inp, codec, kv_dtype):
    """A 1 + 1 fleet at tp 2 driven by hand on the one pre-drawn stream:
    the prefill replica's first round, the handoff of every uid, then the
    decode replica's rounds. Returns each round's logits (controller), and
    every rank's source and destination rows of the shipped blocks."""
    model = llama_model(inp["llama_params"])
    fleet = PrefillDecodeFleet(model, 1, 1, devices=[CPU] * 4, tp_size=2,
                               engine_config=eng_config(kv_dtype), token_budget=48,
                               codec=codec, speculative_default=False)
    out = {}
    if fleet.is_controller:
        pre, dec = fleet.prefill[0][1].engine, fleet.decode[0][1].engine
        shipped = []
        real = pre.ship_followers

        def record(dst, src_blocks, dst_blocks, codec):
            shipped.append((list(src_blocks), list(dst_blocks)))
            return real(dst, src_blocks, dst_blocks, codec)
        pre.ship_followers = record
        rounds = inp["fleet_rounds"]
        logits = [put(pre, rounds[0])]
        uids = [u for u, _ in rounds[0]]
        src_rows = pre._state.kv_cache.export_blocks(
            [b for u in uids for b in pre._state.get_sequence(u).kv_blocks])
        fleet.transport.ship_many(uids, pre, dec)
        logits += [put(dec, batch) for batch in rounds[1:]]
        out["logits"] = logits
        out["stats"] = fleet.transport.stats()
        out["page_wire_cost"] = fleet.transport.page_wire_cost(pre)
        ids = torch.tensor(shipped[0], dtype=torch.int64)
        fleet.stop_followers()
        engines = {0: pre, 1: dec}
    else:
        engines = {k: e for k, e in getattr(fleet._ranks, "engines", {}).items() if e}
        ids = torch.zeros(2, 0, dtype=torch.int64)
        src_rows = None
    n = torch.tensor([ids.shape[1]])
    tdist.broadcast(n, src=0)
    if ids.shape[1] != int(n):
        ids = torch.zeros(2, int(n), dtype=torch.int64)
    tdist.broadcast(ids, src=0)
    if engines:
        kv_src, kv_dst = engines[0]._state.kv_cache, engines[1]._state.kv_cache
        out["dst_rows"] = kv_dst.export_blocks(ids[1].tolist())
        out["src_rows"] = src_rows if src_rows is not None else \
            kv_src.export_blocks(ids[0].tolist())
        out["kv_slots"] = engines[0]._model.plan.spans["kv"]
    return out


def fleet_served(inp):
    """The scheduler-driven fleet at tp 2 (device codec, speculating decode
    side) against a one-replica ``ReplicaGroup`` at tp 2 on the same ranks,
    then the lifecycle: a decode replica raised on the spare slot and one
    lost; the followers' shares follow both."""
    model = llama_model(inp["llama_params"])
    out = {}
    group = ReplicaGroup(model, [CPU] * 2, tp_size=2, engine_config=ENG, token_budget=48)
    if group.is_controller:
        for uid, prompt in inp["served"].items():
            group.submit(uid, prompt, max_new_tokens=6)
        out["group"] = {u: list(map(int, t)) for u, t in group.run_to_completion().items()}
        group.stop_followers()
    fleet = PrefillDecodeFleet(model, 1, 1, devices=[CPU] * 6, tp_size=2,
                               engine_config=ENG, token_budget=48)
    if fleet.is_controller:
        for uid, prompt in inp["served"].items():
            fleet.submit(uid, prompt, max_new_tokens=6)
        out["fleet"] = {u: list(map(int, t)) for u, t in fleet.run_to_completion().items()}
        out["census"] = fleet.page_census()["leaked_pages"]
        j = fleet.scale_up_decode()
        fleet._lose_replica("decode", 0, cause="test")
        for uid, prompt in inp["served"].items():
            fleet.submit(100 + uid, prompt, max_new_tokens=6)
        again = fleet.run_to_completion()
        out["after_loss"] = {u - 100: list(map(int, again[u])) for u in again if u >= 100}
        out["scaled_to"] = j
        fleet.stop_followers()
    else:
        out["follower_tags"] = sorted(k for k, e in getattr(fleet._ranks, "engines",
                                                             {}).items() if e)
    return out


def replica_group_rounds(inp):
    """A 2-replica ``ReplicaGroup`` at tp 2: each replica's engine on its
    share of the pre-drawn rounds (round-robin halves)."""
    model = llama_model(inp["llama_params"])
    group = ReplicaGroup(model, [CPU] * 4, tp_size=2, engine_config=ENG, token_budget=48)
    if not group.is_controller:
        return None
    out = []
    for r, (_, sched) in enumerate(group.replicas):
        out.append([put(sched.engine, [(u + 10 * (r + 1), t) for i, (u, t)
                                       in enumerate(batch) if i % 2 == r])
                    for batch in inp["rounds"]])
    group.stop_followers()
    return out


def v1_idle(inp, rank, out):
    """A (1, 2) v1 grid in the world of 3: rank 2 is idle."""
    model = llama_model(inp["llama_params"])
    eng = deepspeed_tpu_torch.init_inference(
        model, config={"dtype": "fp32", "tensor_parallel": {"tp_size": 2}}, device=CPU)
    out["idle_grid"] = eng.grid
    out["idle"] = eng.idle
    out["idle_weights"] = 0 if eng.module is None else sum(
        p.numel() for p in eng.module.parameters())
    out["idle_logits"] = eng(inp["v1_ids"]).numpy()
    out["idle_greedy"] = eng.generate(inp["v1_ids"], max_new_tokens=6).numpy()
    out["idle_sampled"] = eng.generate(inp["v1_ids"], max_new_tokens=4, temperature=1.0,
                                       top_k=20, rng=7).numpy()
    groups.reset()


def held_bytes(module):
    """Bytes of the distinct storages behind ``module``'s parameters and
    buffers (a view of a whole tensor counts the whole)."""
    storages = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
                for t in list(module.parameters()) + list(module.buffers())}
    return sum(storages.values())


def v1_hf_quantized(inp, tmp, rank, out):
    """An HF directory loaded at tp 2 with 8-bit groups of 16 against the
    same model passed whole; the bytes each rank holds against its share."""
    model = llama_model(inp["llama_params"])
    d = os.path.join(tmp, "hf_llama")
    if rank == 0:
        hf.export_pretrained(model, model.config, d)
    tdist.barrier()
    conf = {"dtype": "fp32", "tensor_parallel": {"tp_size": 2},
            "quant": {"enabled": True, "bits": 8, "group_size": 16}}
    whole = deepspeed_tpu_torch.init_inference(llama_model(inp["llama_params"]),
                                               config=conf, device=CPU)
    out["hfq_whole"] = whole(inp["v1_ids"]).numpy()
    groups.reset()
    loaded = deepspeed_tpu_torch.init_inference(None, config=dict(conf, checkpoint=d),
                                                device=CPU)
    out["hfq_loaded"] = loaded(inp["v1_ids"]).numpy()
    if not loaded.idle:
        from deepspeed_tpu_torch.inference.quantization import QuantizedLinear
        out["hfq_impls"] = {n: m.impl for n, m in loaded.module.named_modules()
                            if isinstance(m, QuantizedLinear)}
        from deepspeed_tpu_torch.inference.quantization import quantized_nbytes
        out["hfq_held"] = [(held_bytes(e.module), quantized_nbytes(e.module))
                           for e in (loaded, whole)]
        out["hfq_same_bits"] = all(
            torch.equal(a, b) for (_, a), (_, b) in zip(
                sorted(whole.module.state_dict().items()),
                sorted(loaded.module.state_dict().items())))
    groups.reset()


def empty_shares(inp, rank, out):
    """2 query heads at tp 4: ranks 2 and 3 hold no heads (v2 on the
    pre-drawn rounds, v1 logits)."""
    model = llama_model(inp["h2_params"], **inp["h2_cfg"])
    out["plan"] = [(TPPlan(model.config, 4, r).heads, TPPlan(model.config, 4, r).kv_heads)
                   for r in range(4)]
    engine = build_engine(model, dict(ENG, tensor_parallel={"tp_size": 4}), device=CPU)
    if engine.is_controller:
        out["v2"] = [put(engine, batch) for batch in inp["rounds"]]
        engine.stop_followers()
    else:
        engine.follow()
    out["pool_heads"] = engine._state.kv_cache.k_pool.shape[2]
    eng = deepspeed_tpu_torch.init_inference(
        llama_model(inp["h2_params"], **inp["h2_cfg"]),
        config={"dtype": "fp32", "tensor_parallel": {"tp_size": 4}}, device=CPU)
    out["v1"] = eng(inp["v1_ids"]).numpy()
    out["v1_greedy"] = eng.generate(inp["v1_ids"], max_new_tokens=6).numpy()
    groups.reset()
    q = deepspeed_tpu_torch.init_inference(
        llama_model(inp["h2_params"], **inp["h2_cfg"]),
        config={"dtype": "fp32", "tensor_parallel": {"tp_size": 4},
                "quant": {"enabled": True, "bits": 8, "group_size": 16}}, device=CPU)
    out["v1_int8"] = q(inp["v1_ids"]).numpy()
    groups.reset()


def w3(inp, rank, world, tmp, out):
    t0 = time.perf_counter()
    for codec, kv in (("device", "fp"), ("wire", "int8"), ("wire", "fp")):
        out[f"fleet_{codec}_{kv}"] = fleet_rounds(inp, codec, kv)
    out["served"] = fleet_served(inp)
    out["group_rounds"] = replica_group_rounds(inp)
    t1 = time.perf_counter()
    v1_idle(inp, rank, out)
    v1_hf_quantized(inp, tmp, rank, out)
    print(f"rank {rank}: fleet {t1 - t0:.1f}s, v1 {time.perf_counter() - t1:.1f}s",
          flush=True)


def w4(inp, rank, world, tmp, out):
    empty_shares(inp, rank, out)


SUITES = {"w3": w3, "w4": w4}


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
            SUITES[suite](inp, rank, world, os.path.dirname(out_path), out)
    except Exception:
        traceback.print_exc()
        raise
    print(f"rank {rank} of {suite}: {time.perf_counter() - start:.1f}s", flush=True)
    torch.save(out, out_path)
    tdist.barrier()
    tdist.destroy_process_group()


if __name__ == "__main__":
    main()
