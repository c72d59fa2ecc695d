"""One rank of the gloo runs of ``tests/test_torch_tensor_parallel_families.py``.

``python tests/test_torch_tensor_parallel_families_worker.py SUITE RANK WORLD
INIT_FILE INPUTS OUT`` joins a gloo process group of WORLD ranks through
``file://INIT_FILE``, runs the scenarios of SUITE ("tp2": OPT, Falcon and
Phi at tp 2, a planted Falcon fault, W8A16 v1 serving, speculative decode
and the host KV tier; "tp4": Llama with 2 KV heads at tp 4) on the inputs
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
from deepspeed_tpu_torch.inference.quantization.quantization import (  # noqa: E402
    QuantizedLinear)
from deepspeed_tpu_torch.inference.v2 import (SplitFuseScheduler, build_engine,  # noqa: E402
                                              build_hf_engine)
from deepspeed_tpu_torch.models import llama as port_llama  # noqa: E402
from deepspeed_tpu_torch.models import opt as port_opt  # noqa: E402
from deepspeed_tpu_torch.models import parallel_block as port_pb  # noqa: E402
from deepspeed_tpu_torch.models.falcon import tiny_falcon_config  # noqa: E402
from deepspeed_tpu_torch.models.phi import tiny_phi_config  # noqa: E402
from deepspeed_tpu_torch.parallel import groups  # noqa: E402
from deepspeed_tpu_torch.parallel import tensor_parallel as tpl  # noqa: E402

CPU = "cpu"
F32 = torch.float32
# the tiny configs of the test module, by name: (model class, config, converter)
FAMILIES = {
    "opt": (port_opt.OPTForCausalLM, port_opt.OPTConfig.tiny(dtype=F32, remat=False),
            port_opt.params_from_flax),
    "falcon": (port_pb.ParallelBlockForCausalLM,
               tiny_falcon_config(hidden_size=48, num_attention_heads=3, dtype=F32,
                                  remat=False), port_pb.params_from_flax),
    "phi": (port_pb.ParallelBlockForCausalLM, tiny_phi_config(dtype=F32, remat=False),
            port_pb.params_from_flax),
    "llama": (port_llama.LlamaForCausalLM,
              port_llama.LlamaConfig.tiny(dtype=F32, remat=False),
              port_llama.params_from_flax),
    "llama_q": (port_llama.LlamaForCausalLM,
                dataclasses.replace(port_llama.LlamaConfig.tiny(dtype=F32, remat=False),
                                    intermediate_size=144), port_llama.params_from_flax),
}
QUANT = {"enabled": True, "bits": 8, "group_size": 16}


def whole_model(inp, name):
    cls, cfg, convert = FAMILIES[name]
    model = cls(cfg)
    model.load_state_dict(convert(inp["params"][name]))
    return model.requires_grad_(False)


def engine_config(tp_size, **state):
    return {"state_manager": dict({"max_ragged_sequence_count": 9,
                                   "max_ragged_batch_size": 64, "max_context": 96,
                                   "num_kv_blocks": 96}, **state),
            "kv_cache": {"block_size": 8, "cache_dtype": "fp32"},
            "tensor_parallel": {"tp_size": tp_size}}


def serve_rounds(engine, rounds):
    """``put`` every round; the controller returns each round's logits, a
    follower its forward count."""
    if not engine.is_controller:
        return engine.follow()
    out = [engine.put([u for u, _ in b], [np.asarray(t, np.int32) for _, t in b])
           for b in rounds]
    engine.stop_followers()
    return out


def shift_dense_columns(model, whole, rank):
    """Planted fault: rank 1's ``dense`` rows of layer 0 read the whole
    weight's columns from the even cut's boundary (mid-head), not from its
    first head's."""
    if rank == 1:
        w = whole.layers[0].dense.weight
        mine = model.layers[0].dense.weight
        start = w.shape[1] // 2
        mine.copy_(w[:, start:start + mine.shape[1]])


def family_runs(inp, rank, world, out):
    """Each family's engine at tp ``world`` on the one recorded stream:
    logits, exchanges, the rank's heads."""
    names = ("opt", "falcon", "phi") if world == 2 else ("llama",)
    for name in names:
        model = whole_model(inp, name)
        engine = build_engine(model, engine_config(world), device=CPU)
        tpl.reset_counts()
        out[name] = serve_rounds(engine, inp["rounds"])
        out[f"{name}_counts"] = tpl.counts()
        out[f"{name}_heads"] = (engine._model.plan.heads, engine._model.plan.kv_heads)
        out[f"{name}_attention"] = engine.attention_impl
    if world == 2:
        engine = build_hf_engine(inp["falcon_hf"], engine_config(2), dtype=F32, device=CPU)
        out["falcon_hf"] = serve_rounds(engine, inp["rounds"])
        whole = whole_model(inp, "falcon")
        engine = build_engine(whole, engine_config(2), device=CPU)
        shift_dense_columns(engine._model, whole, rank)
        out["falcon_fault"] = serve_rounds(engine, inp["rounds"][:1])


def v1_quant_runs(inp, rank, out):
    """``init_inference`` with 8-bit weights at tp 2: logits of the v1 ids,
    each quantized linear's dequantized part ([out, in], fp32) and row."""
    eng = deepspeed_tpu_torch.init_inference(
        whole_model(inp, "llama_q"), config={"dtype": "fp32", "quant": QUANT,
                                             "tensor_parallel": {"tp_size": 2}},
        device=CPU)
    out["v1_q_logits"] = eng(inp["v1_ids"]).numpy()
    parts, impls = {}, {}
    for name, m in eng.module.named_modules():
        if isinstance(m, QuantizedLinear):
            w = m.qp.dequantized(torch.float32)
            parts[f"{name}.weight"] = w.T if m.layout == "kn" else w
            impls[name] = m.impl
    out["v1_q_parts"], out["v1_q_impls"] = parts, impls
    out["v1_q_tokens"] = eng.generate(inp["v1_ids"], max_new_tokens=4).numpy()


def speculative_runs(inp, rank, out):
    """Greedy speculative serving of template prompts at tp 2 (the verify
    forward broadcast to the follower) against the same engine config at
    tp 1 on the controller."""
    cfg = dict(engine_config(1), speculative={"enabled": True, "max_draft_tokens": 4},
               prefix_caching=True)

    def serve(engine):
        if not engine.is_controller:
            return engine.follow(), None
        sched = SplitFuseScheduler(engine, token_budget=24)
        for uid, p in enumerate(inp["spec_prompts"]):
            sched.submit(uid, np.asarray(p, np.int32), max_new_tokens=12)
        streams = {u: list(map(int, t)) for u, t in sched.run_to_completion().items()}
        engine.stop_followers()
        return streams, (sched.speculated_tokens, sched.accepted_tokens)

    model = whole_model(inp, "llama")
    if rank == 0:
        out["spec_tp1"], out["spec_tp1_counts"] = serve(build_engine(model, cfg, device=CPU))
    cfg["tensor_parallel"] = {"tp_size": 2}
    out["spec_tp2"], out["spec_tp2_counts"] = serve(build_engine(model, cfg, device=CPU))


def watch_restores(kv, log):
    """Wrap ``kv``'s spill and restore: each spilled block's pages are kept,
    and each restore's block is compared with them, bit for bit."""
    spill, restore = kv.spill_block, kv.restore_block
    kept = {}

    def rows(block):
        idx = torch.tensor([block], dtype=torch.long)
        return [p.index_select(1, idx).clone() for p in kv._pools()]

    def spill_block(block):
        payload = spill(block)
        kept[id(payload)] = (payload, rows(block))
        return payload

    def restore_block(payload, block):
        restore(payload, block)
        _, want = kept.pop(id(payload))
        log.append(all(torch.equal(a, b) for a, b in zip(rows(block), want)))

    kv.spill_block, kv.restore_block = spill_block, restore_block


def host_tier_runs(inp, rank, out):
    """``tests/test_torch_kv_tiering.py``'s pressure case at tp 2: 40 shared
    tokens park, a 60-token filler spills them under a 12-block pool, a
    reuse request restores them; against the same config at tp 1 and an
    unpressured tp 1 engine. Every rank's restored pages are checked
    against what it spilled."""
    model = whole_model(inp, "llama")

    def cfg(tp_size, blocks, host):
        c = engine_config(tp_size, max_ragged_sequence_count=4, max_ragged_batch_size=16,
                          max_context=128, num_kv_blocks=blocks, host_kv_blocks=host)
        return dict(c, prefix_caching=True)

    def serve(engine, log=None):
        if log is not None:
            watch_restores(engine._state.kv_cache, log)
        if not engine.is_controller:
            return engine.follow(), None
        sched = SplitFuseScheduler(engine, token_budget=16)
        streams = {}
        for uid, (prompt, new) in enumerate(inp["tier_requests"]):
            sched.submit(uid, np.asarray(prompt, np.int32), max_new_tokens=new)
            streams[uid] = list(map(int, sched.run_to_completion()[uid]))
        engine.stop_followers()
        return streams, engine.kv_stats()

    if rank == 0:
        out["tier_tp1"], out["tier_tp1_stats"] = serve(build_engine(model, cfg(1, 12, 16),
                                                                    device=CPU))
        out["tier_roomy"], _ = serve(build_engine(model, cfg(1, 64, 0), device=CPU))
    log = []
    out["tier_tp2"], out["tier_tp2_stats"] = serve(
        build_engine(model, cfg(2, 12, 16), device=CPU), log)
    out["tier_restores_exact"] = log


SUITES = {
    "tp2": lambda inp, rank, world, out: [
        family_runs(inp, rank, world, out), v1_quant_runs(inp, rank, out),
        speculative_runs(inp, rank, out), host_tier_runs(inp, rank, out)],
    "tp4": lambda inp, rank, world, out: [family_runs(inp, rank, world, out)],
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
    groups.reset()
    tdist.barrier()
    tdist.destroy_process_group()


if __name__ == "__main__":
    main()
