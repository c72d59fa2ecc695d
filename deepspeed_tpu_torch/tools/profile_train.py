"""Where one training step spends its time.

    python -m deepspeed_tpu_torch.tools.profile_train [--model llama]
        [--layers N] [--micro 4] [--seq 2048] [--seed 0] [--ep 1]
        [--zero 3 --qgz --world 4] [--qwz] [--hpz N | --mics N]
        [--overlap [--prefetch-depth 1 --grad-buckets 2]]

Builds the model at full width with ``--layers`` of its 32 layers (bf16
weights drawn on the card from ``--seed``): the Llama-2-7B geometry
(``--model llama``, 8 layers by default) or Mixtral-8x7B with the
grouped-GEMM dispatch (``--model mixtral``, 2 layers by default, as
``chip_smoke.py`` trains it). Behind ``deepspeed_tpu_torch.initialize`` with
the configuration ``chip_smoke.py`` trains (bf16, AdamW, WarmupLR, clipping
1.0, GAS 2, every layer recomputed), it takes one warm-up optimizer step,
then times one optimizer step (two micro-steps) with host clocks and traces
another with ``torch.profiler``. Prints one JSON line: wall times, the
device time of the traced step by kernel group (the grouped-GEMM forward,
dx and dW kernels, other GEMMs, the three flash kernels, MoE
routing/sort/scatter, optimizer, the rest; the optimizer step's annotated
span apart), the device's idle share, and the fused CE head's forward and
backward alone (CUDA events; its products are among the GEMMs). Needs a
CUDA device.

``--model gpt2`` profiles ``chip_smoke.py`` phase 28's training instead:
GPT-2 large at full width with ``--layers`` of its 36 (all by default),
micro-batches of 8 x 1024 tokens by default, built under ``zero.Init``,
with phase 28's optimizer and policies (``GPT2_TRAIN``: OneBitLamb from
freeze step 2, so the profiled third step compresses; the ``dots``
policy; ``fused_step``), its CE head on the tied ``wte``.

``--ep N`` (Mixtral) profiles expert-parallel training instead: one spawned
process per card on N cards over NCCL, the experts split over ``ep`` N and
``zero_optimization`` stage 2, each rank a micro-batch of ``--micro`` x
``--seq`` tokens, as ``chip_smoke.py`` phase 13 trains it (8 layers by
default). Every rank traces its step; rank 0 prints its own line, with the
NCCL kernels (the dispatch and combine all-to-alls, the gradient and loss
reductions) as a group of their own.

``--zero 3 --qgz --world 4`` (Llama) profiles ZeRO-3 + qgZ data-parallel
training as ``chip_smoke.py`` phase 11 runs it: one spawned process per card
on ``--world`` cards over NCCL, ``zero_optimization`` stage 3 with
``zero_quantized_gradients``, all 32 layers by default, each rank a
micro-batch of ``--micro`` x ``--seq`` tokens. Rank 0's line adds the qgZ
kernels' groups (``qgz_quantize``, ``qgz_dequant_reduce``), the boundary
exchange (``QgzPlan.reduce``) as an annotated span of the traced step and
by the host's clock around a synchronised call in the timed step
(``boundary_exchange_ms``); the fused CE head is not timed apart (its
weight is a gathered ZeRO-3 chunk).

The rest of ZeRO++ and MiCS on that data-parallel run: ``--qwz``
(``zero_quantized_weights``), ``--hpz N`` (``zero_hpz_partition_size``),
``--mics N`` (``mics_shard_size``) and ``--overlap`` (``overlap.schedule``
with ``--prefetch-depth`` and ``--grad-buckets``). Every multi-card line
adds the profiled step's overlap report (``telemetry/overlap.py`` on the
rank's own CUDA timeline of the ``torch.profiler`` trace): the exposed and
total seconds of each collective class, the all-gathers' hidden share
(overlapped over total), the report's totals and its top advice.
"""

import argparse
import dataclasses
import json
import re
import subprocess
import time
import types

import numpy as np

CONFIG = {
    "train_batch_size": None,            # set from --micro x GAS
    "gradient_accumulation_steps": 2,
    "bf16": {"enabled": True},
    "optimizer": {"type": "AdamW", "params": {"lr": 1e-3, "betas": [0.9, 0.95],
                                              "weight_decay": 0.1}},
    "scheduler": {"type": "WarmupLR", "params": {"warmup_min_lr": 1e-4,
                                                 "warmup_max_lr": 1e-3,
                                                 "warmup_num_steps": 2,
                                                 "warmup_type": "linear"}},
    "gradient_clipping": 1.0,
    "activation_checkpointing": {"policy": "everything"},
    "steps_per_print": 1000,
}

# chip_smoke.py phase 28's settings over CONFIG (GPT2_CONFIG there)
GPT2_TRAIN = {
    "optimizer": {"type": "OneBitLamb", "params": {"lr": 1e-2, "freeze_step": 2,
                                                   "weight_decay": 0.01}},
    "scheduler": {},
    "activation_checkpointing": {"policy": "dots"},
    "fused_step": True,
    "seed": 28,
}


def _group(name):
    n = name.lower()
    if "nccl" in n:
        return "nccl_collectives"
    # the qgZ kernels of csrc/quant_collective.cu: quantize_warp /
    # quantize_block (quantize_kernel before them), dequant_reduce_*
    if "dequant_reduce" in n:
        return "qgz_dequant_reduce"
    if any(k in n for k in ("quantize_warp", "quantize_block", "quantize_kernel")):
        return "qgz_quantize"
    # flash_fwd_ / flash_dq_ / flash_dkv_: the wgmma kernels (bf16/fp16) and the
    # SIMT ones (fp32); grouped_tgmm_: the dW kernels (grouped_tgmm_wgmma,
    # grouped_tgmm_fp32_kernel), ahead of the forward / dx template's name
    for kernel, group in (("flash_fwd_", "flash_fwd"), ("flash_dq_", "flash_dq"),
                          ("flash_dkv_", "flash_dkv"),
                          ("grouped_tgmm", "grouped_gemm_dw")):
        if kernel in n:
            return group
    if "grouped_gemm" in n:       # the row-grouped kernel: forward, or dx
        return "grouped_gemm_dx" if "true>" in n else "grouped_gemm_fwd"
    if any(k in n for k in ("sort", "radix", "scatter", "gather", "index", "scan",
                            "cumsum", "searchsorted", "argmax", "one_hot")):
        return "routing_sort_scatter"
    if any(k in n for k in ("gemm", "nvjet", "cutlass", "xmma", "sm90", "cublas")):
        return "gemm"
    if "foreach" in n or "multi_tensor" in n:
        return "optimizer_foreach"
    if "memcpy" in n or "memset" in n:
        return "copy"
    return "elementwise_and_other"


def _step(engine, batches):
    for b in batches:
        loss = engine(b)
        engine.backward(loss)
        engine.step()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=("llama", "mixtral", "gpt2"), default="llama")
    ap.add_argument("--layers", type=int, default=None,
                    help="layers of 32 (default 8 for llama on one card and 32 on "
                         "more, 2 for mixtral on one card and 8 on more)")
    ap.add_argument("--micro", type=int, default=None, help="default 4 (gpt2: 8)")
    ap.add_argument("--seq", type=int, default=None, help="default 2048 (gpt2: 1024)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ep", type=int, default=1,
                    help="expert-parallel cards (Mixtral; one process per card)")
    ap.add_argument("--zero", type=int, default=0, help="ZeRO stage (with --world > 1)")
    ap.add_argument("--qgz", action="store_true", help="ZeRO++ quantized gradients")
    ap.add_argument("--world", type=int, default=None,
                    help="data-parallel cards (one process per card); --ep sets it for "
                         "expert parallelism")
    ap.add_argument("--qwz", action="store_true", help="ZeRO++ quantized weights (stage 3)")
    ap.add_argument("--hpz", type=int, default=1, help="ZeRO++ hpZ partition size")
    ap.add_argument("--mics", type=int, default=-1, help="MiCS shard size")
    ap.add_argument("--overlap", action="store_true", help="the overlap schedule")
    ap.add_argument("--prefetch-depth", type=int, default=1)
    ap.add_argument("--grad-buckets", type=int, default=2)
    args = ap.parse_args(argv)
    gpt2 = args.model == "gpt2"
    args.micro = args.micro or (8 if gpt2 else 4)
    args.seq = args.seq or (1024 if gpt2 else 2048)
    if gpt2 and (args.world or 1) > 1:
        ap.error("--model gpt2 profiles one card")
    if (args.qwz or args.hpz > 1 or args.mics > 0 or args.overlap) and args.zero < 1:
        ap.error("--qwz, --hpz, --mics and --overlap need --zero (and --world 2 or more)")
    if args.ep > 1:
        if args.model != "mixtral":
            ap.error("--ep needs --model mixtral")
        args.world = args.ep
    args.world = args.world or 1
    if args.qgz and (args.zero < 2 or args.world < 2):
        ap.error("--qgz needs --zero 2 or 3 and --world 2 or more")
    if args.world == 1:
        _profile(args)
        return
    import socket
    import torch.multiprocessing as mp
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    mp.start_processes(_rank, args=(args, port), nprocs=args.world, join=True,
                       start_method="spawn")


def _rank(rank, args, port):
    import os
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(args.world), LOCAL_RANK=str(rank),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    from deepspeed_tpu_torch.comm import comm as dist
    dist.init_distributed(dist_backend="nccl", timeout=300, verbose=False)
    _profile(args, rank)
    dist.barrier()
    dist.destroy_process_group()


def _exchange_probe(engine):
    """Wraps the engine's qgZ exchange (``QgzPlan.reduce``), if it has one:
    a span annotated ``qgz.reduce#boundary_exchange`` in a trace, and while
    ``probe.timing`` is set, the host's milliseconds around a synchronised
    call appended to ``probe.ms``."""
    import torch
    from torch.profiler import record_function
    probe = types.SimpleNamespace(ms=[], timing=False, step_ms=None)
    plan = engine._qgz
    if plan is None:
        return probe
    inner = plan.reduce

    def reduce(*a, **kw):
        if probe.timing:
            torch.cuda.synchronize()
        t = time.perf_counter()
        with record_function("qgz.reduce#boundary_exchange"):
            out = inner(*a, **kw)
        if probe.timing:
            torch.cuda.synchronize()
            probe.ms.append((time.perf_counter() - t) * 1e3)
        return out

    plan.reduce = reduce
    return probe


def overlap_summary(prof, rank):
    """The overlap report of this rank's card in the trace ``prof`` took:
    per collective class its exposed and total seconds, the all-gathers'
    hidden share, the totals and the first advice; ``busy_s``, the union of
    the card's kernel and copy intervals over all its streams."""
    import tempfile
    from pathlib import Path

    from deepspeed_tpu_torch.telemetry import overlap as ov
    build = Path(__file__).resolve().parents[2] / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as d:
        path = str(Path(d) / f"rank{rank}.trace.json")
        prof.export_chrome_trace(path)
        per = ov.intervals_from_trace(ov.load_trace_events(path))
    mine = {k: v for k, v in per.items() if k == f"cuda:{rank}"}
    rep = ov.overlap_report(mine, top_k=1000)
    classes = {}
    for c in rep["collectives"]:
        k = classes.setdefault(c["op"], {"count": 0, "total_s": 0.0, "exposed_s": 0.0})
        k["count"] += c["count"]
        k["total_s"] += c["total_s"]
        k["exposed_s"] += c["exposed_s"]
    gather = classes.get("all_gather")
    return {"device": f"cuda:{rank}", "classes": classes,
            "all_gather_hidden_share": (1 - gather["exposed_s"] / gather["total_s"])
            if gather and gather["total_s"] > 0 else None,
            **{k: rep[k] for k in ("step_s", "compute_s", "comm_s", "overlapped_comm_s",
                                   "exposed_comm_s", "gap_s", "overlap_fraction",
                                   "exposed_fraction")},
            "busy_s": rep["step_s"] - rep["gap_s"],
            "advice": rep["advice"][:1]}


def _profile(args, rank=0):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from deepspeed_tpu_torch.models.losses import lm_head_next_token_loss
    from deepspeed_tpu_torch.models.mixtral import MixtralConfig, MixtralForCausalLM

    world = args.world
    dev = torch.device("cuda", rank)
    torch.cuda.set_device(dev)
    config = dict(CONFIG, train_batch_size=args.micro * CONFIG["gradient_accumulation_steps"]
                  * world)
    if args.zero:
        config.update(train_micro_batch_size_per_gpu=args.micro, zero_optimization={
            "stage": args.zero, "zero_quantized_gradients": args.qgz,
            "zero_quantized_weights": args.qwz, "zero_hpz_partition_size": args.hpz,
            "mics_shard_size": args.mics})
        if args.overlap:
            config["overlap"] = {"schedule": True, "prefetch_depth": args.prefetch_depth,
                                 "grad_buckets": args.grad_buckets}
    if args.model == "mixtral":
        args.layers = args.layers or (2 if world == 1 else 8)
        ep = args.ep
        cfg = MixtralConfig.mixtral_8x7b(num_hidden_layers=args.layers, moe_backend="gmm")
        model = MixtralForCausalLM.from_seed(cfg, seed=args.seed, device=dev,
                                             ep_size=ep, ep_rank=rank % ep)
        if ep > 1:
            config.update(train_micro_batch_size_per_gpu=args.micro,
                          expert_parallel_size=ep, zero_optimization={"stage": 2})
    elif args.model == "gpt2":
        from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHeadModel
        cfg = GPT2Config.large()
        args.layers = args.layers or cfg.n_layer
        cfg = dataclasses.replace(cfg, n_layer=args.layers)
        config = dict(config, **GPT2_TRAIN)
        with deepspeed_tpu_torch.zero.Init(config=config):
            model = GPT2LMHeadModel(cfg)
    else:
        args.layers = args.layers or (8 if world == 1 else 32)
        cfg = LlamaConfig.llama2_7b(num_hidden_layers=args.layers)
        model = LlamaForCausalLM.from_seed(cfg, seed=args.seed, device=dev)
    engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=config, device=dev)
    rng = np.random.default_rng(args.seed)
    batches = []
    for _ in range(config["gradient_accumulation_steps"]):
        ids = rng.integers(0, cfg.vocab_size, (args.micro * world, args.seq))
        mine = ids[rank * args.micro:(rank + 1) * args.micro]
        batches.append({"input_ids": mine, "labels": mine})

    exchange = _exchange_probe(engine)
    _step(engine, batches)                      # warm-up step
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _step(engine, batches)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    if engine._qgz is not None:             # a step with the exchange timed apart
        exchange.timing = True
        t0 = time.perf_counter()
        _step(engine, batches)
        torch.cuda.synchronize()
        exchange.step_ms = (time.perf_counter() - t0) * 1e3
        exchange.timing = False

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _step(engine, batches)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    overlap = overlap_summary(prof, rank)
    # busy: the union of the card's intervals, as streams overlap (NCCL
    # beside compute under the overlap schedule)
    busy_ms = overlap["busy_s"] * 1e3
    # device-side events only: the host ops that launched them carry the
    # same time and would count it twice. Annotations (the optimizer's
    # "Optimizer.step#..." range, the process groups' "nccl:<op>" ranges)
    # span kernels counted on their own: kept apart as spans.
    device = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    spans = {e.key: e.device_time_total / 1e3 for e in device
             if re.fullmatch(r"[\w.]+#[\w.]+", e.key) or e.key.startswith("nccl:")}
    per_kernel, groups, counts = {}, {}, {}
    for e in device:
        if e.key in spans:
            continue
        ms = e.device_time_total / 1e3
        per_kernel[e.key] = per_kernel.get(e.key, 0.0) + ms
        g = _group(e.key)
        groups[g] = groups.get(g, 0.0) + ms
        counts[g] = counts.get(g, 0) + e.count
    if rank:
        return
    line = {
        "card": subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip().splitlines()[0],
        "model": args.model, "layers": args.layers, "params": cfg.num_parameters(),
        "world": world, "expert_parallel": args.ep, "zero_stage": args.zero, "qgz": args.qgz,
        "qwz": args.qwz, "hpz": args.hpz, "mics": args.mics,
        "overlap_schedule": config.get("overlap"),
        "micro_batch": [args.micro, args.seq],
        "peak_memory_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
        "gas": config["gradient_accumulation_steps"],
        "step_wall_ms_unprofiled": step_ms,
        "step_wall_ms_profiled": wall_ms,
        "device_busy_ms": busy_ms if per_kernel else None,
        "device_idle_share": (1 - busy_ms / wall_ms) if per_kernel else None,
        "device_kernel_ms_summed": sum(per_kernel.values()),
        "groups_ms_per_step": groups,
        "group_launches_per_step": counts,
        "annotated_spans_ms": spans,
        "top_kernels_ms_per_step": {k[:90]: v for k, v in sorted(
            per_kernel.items(), key=lambda kv: -kv[1])[:12]}}
    if exchange.ms:
        line.update(boundary_exchange_ms=exchange.ms,
                    step_wall_ms_exchange_synchronised=exchange.step_ms)
    if world > 1:
        line["overlap_report"] = overlap
    if args.zero == 3:
        print(json.dumps(line))
        return

    # the fused CE head alone on the step's shapes
    hidden = cfg.n_embd if args.model == "gpt2" else cfg.hidden_size
    x = torch.randn(args.micro, args.seq, hidden, device=dev,
                    dtype=torch.bfloat16, requires_grad=True)
    labels = torch.from_numpy(batches[0]["labels"]).to(dev)
    head = model.wte.weight if args.model == "gpt2" else model.lm_head.weight

    def ce():
        lm_head_next_token_loss(x, head, labels).backward()
        x.grad = None
        head.grad = None

    ce()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        ce()
    end.record()
    end.synchronize()

    line["fused_ce_fwd_bwd_ms_per_micro_step"] = start.elapsed_time(end) / 3
    print(json.dumps(line))


if __name__ == "__main__":
    main()
