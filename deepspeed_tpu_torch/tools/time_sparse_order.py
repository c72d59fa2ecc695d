"""How much the block-sparse forward's work order matters on the GPU.

    python -m deepspeed_tpu_torch.tools.time_sparse_order [--seed 17]

At Llama-2-7B attention width (B 1, 32 heads of 128, S 16384, bf16), under
``FixedSparsityConfig(block=64, attention="unidirectional")`` with causal
on and under ``BigBirdSparsityConfig(block=64)``, times the tensor-core
kernel (``sparse_mha_fwd``) with its work items in three orders, each twice
in turns (descending, natural, ascending, then back): descending
``counts``, the wrapper's ``work_order``; the natural (head, query block)
order; and ascending ``counts``. The order changes only the schedule, so the
three outputs must be bitwise equal. Prints one JSON line with the card's
name and power limit, the times in ms (CUDA events, 10 launches each after
one warm-up) and the layout's block visits. Needs a CUDA device.
"""

import argparse
import json
import subprocess

import numpy as np
import torch

from deepspeed_tpu_torch.ops import block_sparse_attention as bsa
from deepspeed_tpu_torch.ops import sparse_attention as sa

B, H, S, D, BLOCK = 1, 32, 16384, 128, 64
ITERS = 10


def _time_ms(fn):
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(ITERS):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / ITERS


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=17)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_sparse_order needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    configs = {"fixed_7b": (sa.FixedSparsityConfig(num_heads=H, block=BLOCK,
                                                   attention="unidirectional"), True),
               "bigbird_7b": (sa.BigBirdSparsityConfig(num_heads=H, block=BLOCK), False)}
    report = {"card": card, "shape": f"B={B} H={H} S={S} D={D} block={BLOCK} bfloat16"}
    for name, (config, causal) in configs.items():
        cols_np, counts_np = bsa.compact_layout(config.make_layout(S), causal, BLOCK)
        cols, counts = (torch.from_numpy(a).cuda() for a in (cols_np, counts_np))
        q, k, v = (torch.randn(B, H, S, D, generator=gen, device="cuda").to(torch.bfloat16)
                   for _ in range(3))
        desc = bsa.work_order(counts_np)
        orders = {"descending": desc, "natural": np.arange(desc.size, dtype=np.int32),
                  "ascending": np.ascontiguousarray(desc[::-1])}
        orders = {n: torch.from_numpy(o).cuda() for n, o in orders.items()}
        run = lambda o: bsa.sparse_mha_fwd(q, k, v, cols, counts, BLOCK, causal, D ** -0.5, o)
        times = {n: [] for n in orders}
        for turn in (list(orders), list(orders)[::-1]):
            for n in turn:
                times[n].append(_time_ms(lambda: run(orders[n])))
        outs = {n: run(o) for n, o in orders.items()}
        report[name] = dict(
            ms=times, outputs_bitwise_equal=all(torch.equal(outs["descending"], o)
                                                for o in outs.values()),
            block_visits=int(counts_np.sum()) * B, max_count=int(counts_np.max()),
            mean_count=float(counts_np.mean()))
    print(json.dumps(report))


if __name__ == "__main__":
    main()
