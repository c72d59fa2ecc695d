"""Where a decode round of Llama-2-7B or Mixtral-8x7B serving spends its
time on the GPU.

    python -m deepspeed_tpu_torch.tools.profile_decode [--model llama]
        [--seqs 8] [--prompt 512] [--rounds 4] [--seed 0]

``--speculative`` (Llama only) turns on draft-then-verify decode (4 drafts,
n-grams up to 3) and gives each request a template prompt, a 2-4 token
random pattern tiled to ``--prompt`` tokens, so the n-gram drafter fires;
the line then also carries the tokens committed per round and the accept
rate over the profiled rounds.

``--model llama-int8`` profiles the v1 engine instead: Llama-2-7B (all 32
layers) quantized to int8 by ``init_inference``; each round is one call of
its entry point, ``engine.generate`` of ``INT8_NEW_TOKENS`` greedy tokens
for ``--seqs`` prompts of ``--prompt`` random tokens (a prefill into the
fixed-window KV cache, then the decode loop).

Serves ``--seqs`` greedy requests of ``--prompt`` random tokens through
``build_engine`` + ``SplitFuseScheduler`` on Llama-2-7B (all 32 layers) or
Mixtral-8x7B (``--model mixtral``: full width, 16 of its 32 layers, the
depth at which its bf16 weights fit in 80 GB), bf16 weights
drawn on the card from ``--seed``; runs until every request decodes, then
traces ``--rounds`` decode rounds with ``torch.profiler``. Prints one JSON
line: the wall time per round without and with the profiler, the device
busy time per round (sum of kernel and copy times), its idle share of the
profiled rounds, and the device time per round of the heaviest kernels and
of kernel groups (grouped GEMM, GEMM, paged attention, the rest). Needs a
CUDA device.
"""

import argparse
import json
import subprocess
import time

import numpy as np


def _group(name):
    n = name.lower()
    if "paged_mha" in n:
        return "paged_attention"
    if "quantized_matmul" in n or "split_reduce" in n:
        return "quantized_matmul"
    if "grouped_gemm" in n:
        return "grouped_gemm"
    if any(k in n for k in ("gemm", "gemv", "nvjet", "cutlass", "xmma", "sm90")):
        return "gemm"
    if "memcpy" in n or "memset" in n:
        return "copy"
    if "index" in n or "scatter" in n or "gather" in n:
        return "index"
    return "elementwise_and_other"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=("llama", "mixtral", "llama-int8"), default="llama")
    ap.add_argument("--seqs", type=int, default=8)
    ap.add_argument("--prompt", type=int, default=512)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--speculative", action="store_true",
                    help="draft-then-verify decode on template prompts (llama)")
    args = ap.parse_args(argv)
    if args.speculative and args.model != "llama":
        ap.error("--speculative profiles the Llama engine only")

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from deepspeed_tpu_torch.inference.v2 import SplitFuseScheduler, build_engine
    if args.model == "llama-int8":
        step, cfg = _int8_generate(args)
    elif args.model == "mixtral":
        from deepspeed_tpu_torch.models.mixtral import (
            MixtralConfig as Config, MixtralForCausalLM as Model)
        cfg = Config.mixtral_8x7b(num_hidden_layers=16)
    else:
        from deepspeed_tpu_torch.models.llama import (
            LlamaConfig as Config, LlamaForCausalLM as Model)
        cfg = Config.llama2_7b()
    if args.model != "llama-int8":
        model = Model.from_seed(cfg, seed=args.seed)
        bs = 64
        # speculating rows commit up to 5 tokens a round
        new_tokens = 64 + (10 * (args.rounds + 1) if args.speculative else 0)
        per_seq = -(-(args.prompt + new_tokens + 2 * args.rounds) // bs)
        engine = build_engine(model, {
            "state_manager": {"max_ragged_sequence_count": args.seqs,
                              "max_ragged_batch_size": 512,
                              "max_context": 2048,
                              "num_kv_blocks": args.seqs * per_seq},
            "kv_cache": {"block_size": bs, "cache_dtype": "bf16"},
            "speculative": {"enabled": args.speculative, "max_draft_tokens": 4,
                            "ngram_max": 3}})
        sched = SplitFuseScheduler(engine)
        rng = np.random.default_rng(args.seed)
        for uid in range(args.seqs):
            if args.speculative:
                pattern = rng.integers(0, cfg.vocab_size, int(rng.integers(2, 5)))
                prompt = np.resize(pattern, args.prompt)
            else:
                prompt = rng.integers(0, cfg.vocab_size, args.prompt)
            sched.submit(uid, prompt, max_new_tokens=new_tokens)
        while any(len(t) == 0 for t in sched.results().values()):
            sched.step()
        step = sched.step
    for _ in range(2):          # warm decode rounds
        step()
    t0 = time.perf_counter()
    for _ in range(args.rounds):
        step()
    plain_round_ms = (time.perf_counter() - t0) / args.rounds * 1e3
    if args.model != "llama-int8":
        tokens0 = sum(len(t) for t in sched.results().values())
        drafts0 = (sched.speculated_tokens, sched.accepted_tokens)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.rounds):
            step()
        wall = time.perf_counter() - t0
    spec = {}
    if args.model != "llama-int8":
        drafted = sched.speculated_tokens - drafts0[0]
        spec = {"speculative": args.speculative,
                "tokens_per_round": (sum(len(t) for t in sched.results().values())
                                     - tokens0) / args.rounds,
                "drafted_per_round": drafted / args.rounds,
                "accept_rate": (sched.accepted_tokens - drafts0[1]) / drafted
                if drafted else None}
    # device-side events only (kernels, copies): host ops that launched
    # them carry the same time and would count it twice
    device = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    per_kernel = {}
    for e in device:
        per_kernel[e.key] = per_kernel.get(e.key, 0.0) + e.device_time_total / 1e3
    busy_ms = sum(per_kernel.values()) / args.rounds
    groups = {}
    for name, ms in per_kernel.items():
        g = _group(name)
        groups[g] = groups.get(g, 0.0) + ms / args.rounds
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:12]
    round_ms = wall / args.rounds * 1e3
    print(json.dumps({
        "card": subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0],
        "model": args.model, "layers": cfg.num_hidden_layers,
        "seqs": args.seqs, "prompt": args.prompt, "rounds": args.rounds, **spec,
        "round_wall_ms_unprofiled": plain_round_ms,
        "round_wall_ms_profiled": round_ms,
        "device_busy_ms_per_round": busy_ms if per_kernel else None,
        "device_idle_share": (1 - busy_ms / round_ms) if per_kernel else None,
        "groups_ms_per_round": groups,
        "top_kernels_ms_per_round": {k[:90]: v / args.rounds for k, v in top},
        # launches of the rows' kernels, not of the passes that merge their
        # key splits (quantized_matmul_split_reduce, paged_mha_combine)
        "quantized_matmul_kernels_per_round": sum(
            e.count for e in device
            if "quantized_matmul" in e.key and "split_reduce" not in e.key) / args.rounds,
        "paged_mha_kernels_per_round": sum(
            e.count for e in device
            if "paged_mha" in e.key and "combine" not in e.key) / args.rounds,
        "grouped_gemm_kernels_per_round": sum(
            e.count for e in device if "grouped_gemm" in e.key) / args.rounds}))


INT8_NEW_TOKENS = 32


def _int8_generate(args):
    """(round, config): one ``engine.generate`` call of the int8 v1 engine
    per round."""
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    cfg = LlamaConfig.llama2_7b()
    engine = deepspeed_tpu_torch.init_inference(
        LlamaForCausalLM.from_seed(cfg, seed=args.seed),
        config={"dtype": "bf16", "quant": {"enabled": True, "bits": 8, "group_size": 256}})
    rng = np.random.default_rng(args.seed)
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, (args.seqs, args.prompt))).cuda()

    def generate():
        engine.generate(ids, max_new_tokens=INT8_NEW_TOKENS)
        torch.cuda.synchronize()
    return generate, cfg


if __name__ == "__main__":
    main()
