#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``deepspeed_tpu_torch``) on one GPU.

Run from the repository root: ``python3 chip_smoke.py``. It needs a CUDA
device and the repository's sources; without either it exits non-zero and
prints no result.

1. Builds every kernel of the serving path from ``deepspeed_tpu_torch/csrc``
   with nvcc (sm_90a) and prints the build time.
2. Kernels against their plain PyTorch versions on the card, at the shapes
   of Llama-2-7B serving (decode with ragged seen lengths up to ~4000, a
   256-token prefill chunk, a serving round's 512-row chunk beside padded
   decode rows), plus GQA, a sliding window, int8 pools, fp16, fp32, a
   256-wide head, seen=0 rows and q_len=0 padding rows. For each case: the
   error against the per-element bound stated below, the same for a planted
   one-page fault that the bound must reject, kernel / plain / library (page
   gather + SDPA, a yardstick the port never calls) times from CUDA events,
   and the bound: the larger of bytes over 3.35 TB/s and attention
   operations over the dtype's peak (989 TFLOP/s bf16/fp16, 67 TFLOP/s
   fp32), counted from this case's data.
3. Serving: Llama-2-7B at full width and all 32 layers, bf16 weights drawn
   on the card from a seed, behind ``build_engine``. One prompt's
   first-token logits from the kernel-backed forward are compared with the
   same forward run with the plain attention, and so is a control whose
   plain attention misreads one page. Then ``SplitFuseScheduler`` serves 8
   greedy requests (prompts of 64-1500 tokens, 64 new tokens each) to
   completion; every kernel's launch counter must equal
   ``num_layers x forwards`` for that run.

The line before the last is one JSON object describing each kernel; the
last is ``{"ok": true, "device": {...}}``. Any failure raises, so the
script exits non-zero without it.
"""

import json
import re
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12                # H100 SXM HBM3
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
# Per-element bound |kernel - plain| <= ATOL + RTOL[dtype] * |plain|. Kernel
# and plain version compute in fp32 from the same inputs (expf, fp32 sums)
# and differ only in summation order before the final rounding to the output
# dtype; that rounding moves a value by at most one unit in its last place,
# 2^-7 of it in bf16 and 2^-10 in fp16, and fp32 outputs are not rounded
# again. ATOL covers the fp32 summation-order noise of elements near 0. Each
# case also plants a one-page fault in the plain version and fails unless the
# bound rejects it. Readings (H100 80GB HBM3, 700 W): the kernel's errors
# reached 0.61-0.96x the bound in bf16/fp16 (one rounding) and 0.023x in
# fp32; the planted faults 500-16000x.
ATOL = 2e-5
RTOL = {"bfloat16": 2 ** -7, "float16": 2 ** -10, "float32": 2 ** -16}
# First-token logits of an 8-page prompt, kernel-backed forward vs the same
# forward with the plain attention, as relative L2 error |a - b| / |b|: the
# two attentions differ by one rounding of some bf16 outputs, and those
# flips are carried through 32 layers of random weights. A control, the plain
# attention reading the trash page in place of the prompt's 4th page in every
# layer, must land above the bound. Readings (H100 80GB HBM3, 700 W): kernel
# 0.039, control 1.15; the bound sits between them with margin both ways.
LOGITS_REL_L2_TOLERANCE = 0.1
LOGITS_PROMPT = 500          # tokens: 8 pages of 64
LOGITS_FAULT_PAGE = 3


def fail(msg):
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(1)


def nvidia_smi():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters):
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# phase 1: kernel vs plain version
# ---------------------------------------------------------------------------

CASES = [
    # name, S, Q, H, KV, Dh, bs, dtype, int8, window, seen (lo, hi) or list,
    # q_len list (None: Q for every row)
    ("decode_7b", 32, 1, 32, 32, 128, 64, "bfloat16", False, None, (1, 4000),
     None),
    ("prefill_chunk_7b", 4, 256, 32, 32, 128, 64, "bfloat16", False, None,
     [0, 300, 1000, 1800], None),
    # the serving round's mixed shape: a chunk in a 512 bucket beside decode
    # rows padded to 512 and an empty slot
    ("mixed_chunk_decode_7b", 8, 512, 32, 32, 128, 64, "bfloat16", False,
     None, [700, 1500, 37, 2000, 900, 5, 1200, 0],
     [506, 1, 1, 1, 1, 1, 1, 0]),
    ("decode_gqa", 32, 1, 32, 8, 128, 64, "bfloat16", False, None, (1, 4000),
     None),
    ("chunk_gqa_window", 4, 64, 32, 8, 128, 64, "bfloat16", False, 512,
     (600, 3000), None),
    ("decode_int8", 32, 1, 32, 32, 128, 64, "bfloat16", True, None, (1, 4000),
     None),
    ("chunk_int8_gqa", 4, 64, 32, 8, 128, 64, "bfloat16", True, None,
     (0, 2000), None),
    ("chunk_fp16", 4, 16, 32, 8, 128, 64, "float16", False, None, (0, 2000),
     None),
    ("chunk_fp32", 4, 16, 32, 8, 128, 64, "float32", False, None, (0, 2000),
     None),
    ("dh256_window_bs16", 4, 4, 8, 2, 256, 16, "bfloat16", False, 40,
     (0, 300), None),
    ("seen0_and_padding", 8, 8, 32, 32, 128, 64, "bfloat16", False, None,
     [0, 0, 5, 70, 0, 0, 130, 1], [8, 1, 3, 0, 0, 8, 5, 0]),
]


def make_case(case, gen, rng):
    import torch
    name, S, Q, H, KV, Dh, bs, dtype, int8, window, seen, q_len = case
    dev = gen.device
    dt = getattr(torch, dtype)
    if isinstance(seen, tuple):
        seen = rng.integers(seen[0], seen[1], S).tolist()
    q_len = q_len or [Q] * S
    n_blocks = [max(1, -(-(s + Q) // bs)) for s in seen]
    MB = max(n_blocks)
    NB = sum(n_blocks) + 1
    ids = rng.permutation(NB - 1).tolist()
    bt = [[NB - 1] * MB for _ in range(S)]
    for i, n in enumerate(n_blocks):
        bt[i][:n] = [ids.pop() for _ in range(n)]
    q = torch.randn(S, Q, H, Dh, generator=gen, device=dev).to(dt)
    shape = (NB, KV, bs, Dh)
    if int8:
        k = torch.randint(-127, 128, shape, generator=gen, device=dev,
                          dtype=torch.int8)
        v = torch.randint(-127, 128, shape, generator=gen, device=dev,
                          dtype=torch.int8)
        sshape = (NB, KV, 1, bs)
        ks = 0.005 + 0.01 * torch.rand(sshape, generator=gen, device=dev)
        vs = 0.005 + 0.01 * torch.rand(sshape, generator=gen, device=dev)
    else:
        k = torch.randn(shape, generator=gen, device=dev).to(dt)
        v = torch.randn(shape, generator=gen, device=dev).to(dt)
        ks = vs = None
    i32 = dict(dtype=torch.int32, device=dev)
    return dict(q=q, k_pool=k, v_pool=v,
                block_tables=torch.tensor(bt, **i32),
                seen=torch.tensor(seen, **i32),
                q_len=torch.tensor(q_len, **i32),
                k_scale=ks, v_scale=vs, window=window)


def work(case, a):
    """(bytes, operations) the function must move and do for these inputs:
    q and the output once, each visible key's K and V row (and int8 scales)
    once, the tables; 4 * Dh operations per head and visible (row, key)."""
    name, S, Q, H, KV, Dh, bs, dtype, int8, window, _, _ = case
    item = a["q"].element_size()
    kv_item = 1 if int8 else item
    nbytes = 2 * a["q"].numel() * item + a["block_tables"].numel() * 4 + 8 * S
    ops = 0
    for s, ql in zip(a["seen"].tolist(), a["q_len"].tolist()):
        if ql == 0:
            continue
        hi = s + ql
        lo = max(0, s - window + 1) if window else 0
        nbytes += 2 * (hi - lo) * KV * (Dh * kv_item + (4 if int8 else 0))
        for qi in range(ql):
            p = s + qi + 1
            ops += 4 * Dh * H * (min(p, window) if window else p)
    return nbytes, ops


def library_call(a):
    """One yardstick computation of the same function with PyTorch's own
    kernels: gather the pages, then scaled_dot_product_attention under the
    visibility mask. Timed only; the port never calls it."""
    import torch
    import torch.nn.functional as F
    q, kp, vp = a["q"], a["k_pool"], a["v_pool"]
    S, Q, H, Dh = q.shape
    _, KV, bs, _ = kp.shape
    bt = a["block_tables"].long()
    MB = bt.shape[1]
    k = kp[bt].permute(0, 2, 1, 3, 4).reshape(S, KV, MB * bs, Dh)
    v = vp[bt].permute(0, 2, 1, 3, 4).reshape(S, KV, MB * bs, Dh)
    if KV != H:
        k = k.repeat_interleave(H // KV, dim=1)
        v = v.repeat_interleave(H // KV, dim=1)
    kpos = torch.arange(MB * bs, device=q.device)
    qpos = a["seen"].long()[:, None] + torch.arange(Q, device=q.device)
    mask = kpos[None, None, :] <= qpos[:, :, None]
    if a["window"]:
        mask &= kpos[None, None, :] > (qpos - a["window"])[:, :, None]
    return F.scaled_dot_product_attention(q.transpose(1, 2), k, v,
                                          attn_mask=mask[:, None])


def err_ratio(out, ref, dtype):
    """Largest |out - ref| / (ATOL + RTOL * |ref|) over the elements: the
    comparison passes when it is at most 1."""
    ref = ref.float()
    bound = ATOL + RTOL[dtype] * ref.abs()
    return ((out.float() - ref).abs() / bound).max().item()


def plant_page_fault(case, a):
    """Block tables in which the longest live sequence reads the trash page
    (random data that no sequence reads) in place of the page holding the
    middle key that its last query row sees."""
    window, bs = case[9], case[6]
    seen, q_len = a["seen"].tolist(), a["q_len"].tolist()
    s = max((i for i, n in enumerate(q_len) if n),
            key=lambda i: seen[i] + q_len[i])
    hi = seen[s] + q_len[s] - 1
    lo = max(0, hi - window + 1) if window else 0
    bt = a["block_tables"].clone()
    bt[s, (lo + hi) // 2 // bs] = a["k_pool"].shape[0] - 1
    return bt


def phase_kernels():
    import numpy as np
    import torch
    from deepspeed_tpu_torch.ops.paged_attention import (paged_mha,
                                                         paged_mha_reference)
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 plain version in fp32
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    rng = np.random.default_rng(0)
    results, failures = [], []
    for case in CASES:
        name, S, Q, H, KV, Dh, bs, dtype, int8, window, _, _ = case
        a = make_case(case, gen, rng)
        args = (a["q"], a["k_pool"], a["v_pool"], a["block_tables"],
                a["seen"], a["q_len"])
        kw = dict(k_scale=a["k_scale"], v_scale=a["v_scale"],
                  window=a["window"])
        out = paged_mha(*args, **kw)
        ref = paged_mha_reference(*args, **kw)
        faulty = paged_mha_reference(*args[:3], plant_page_fault(case, a),
                                     *args[4:], **kw)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        ratio = err_ratio(out, ref, dtype)
        fault_ratio = err_ratio(faulty, ref, dtype)
        finite = bool(torch.isfinite(out).all())
        del faulty
        iters = 20 if Q == 1 else 10
        ms = time_ms(lambda: paged_mha(*args, **kw), iters)
        plain_ms = time_ms(lambda: paged_mha_reference(*args, **kw), 3)
        lib_ms = None if int8 else time_ms(lambda: library_call(a), 3)
        nbytes, ops = work(case, a)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / PEAK_FLOPS[dtype] * 1e3
        res = dict(name=name, shape=f"S={S} Q={Q} H={H} KV={KV} Dh={Dh} "
                   f"bs={bs} {dtype}{' int8-pool' if int8 else ''}"
                   f"{f' window={window}' if window else ''}",
                   max_abs_err=err, err_ratio=ratio,
                   planted_fault_ratio=fault_ratio,
                   tolerance=f"{ATOL} + {RTOL[dtype]} |plain|",
                   ms=ms, plain_ms=plain_ms,
                   library_ms=lib_ms, bound_ms=max(bytes_ms, ops_ms),
                   bound_by="bytes" if bytes_ms >= ops_ms else "operations")
        results.append(res)
        print(f"kernel case {json.dumps(res)}", flush=True)
        if not finite:
            failures.append(f"{name}: kernel output is not finite")
        if not ratio <= 1:
            failures.append(f"{name}: kernel disagrees with its plain version:"
                            f" error {ratio:.3g}x the bound")
        if not fault_ratio > 1:
            failures.append(f"{name}: the bound does not reject a planted "
                            f"one-page fault ({fault_ratio:.3g}x the bound)")
        del a, args, kw, out, ref
        torch.cuda.empty_cache()
    if failures:
        fail("; ".join(failures))
    return results


# ---------------------------------------------------------------------------
# phase 2: serving Llama-2-7B through the port's entry points
# ---------------------------------------------------------------------------

def phase_serving():
    import numpy as np
    import torch
    from deepspeed_tpu_torch.inference.v2 import SplitFuseScheduler, build_engine
    from deepspeed_tpu_torch.inference.v2.model_implementations.llama import (
        ragged_forward)
    from deepspeed_tpu_torch.inference.v2.ragged.kv_cache import BlockedKVCache
    from deepspeed_tpu_torch.inference.v2.ragged.ragged_wrapper import (
        RaggedBatchWrapper)
    from deepspeed_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from deepspeed_tpu_torch.ops.paged_attention import (paged_mha,
                                                         paged_mha_reference)

    cfg = LlamaConfig.llama2_7b()
    t0 = time.perf_counter()
    model = LlamaForCausalLM.from_seed(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    print(f"serving: Llama-2-7B {cfg.num_parameters() / 1e9:.2f}B params, "
          f"{cfg.num_hidden_layers} layers, bf16 weights drawn in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    bs, max_ctx, budget = 64, 2048, 512
    ecfg = {"state_manager": {"max_ragged_sequence_count": 8,
                              "max_ragged_batch_size": budget,
                              "max_context": max_ctx,
                              "num_kv_blocks": 256},
            "kv_cache": {"block_size": bs, "cache_dtype": "bf16"}}
    engine = build_engine(model, ecfg)
    if engine.attention_impl != "cuda_paged":
        fail(f"engine picked attention {engine.attention_impl!r}")
    rng = np.random.default_rng(0)

    # first-token logits: kernel-backed forward vs the plain attention, and
    # the plain attention with a page fault as the control
    prompt = rng.integers(0, cfg.vocab_size, LOGITS_PROMPT).astype(np.int32)
    kernel_logits = engine.put([1000], [prompt])[0]
    engine.flush(1000)
    n_pages = -(-LOGITS_PROMPT // bs)
    wrapper = RaggedBatchWrapper(8, budget, max_ctx // bs, n_pages)
    wrapper.insert_sequence(0, prompt, 0, list(range(n_pages)))
    arrays = {k: torch.from_numpy(v).cuda() for k, v in wrapper.build().items()}

    def faulty_attention(q, k_pool, v_pool, block_tables, *args, **kw):
        block_tables = block_tables.clone()
        block_tables[0, LOGITS_FAULT_PAGE] = k_pool.shape[0] - 1   # trash page
        return paged_mha_reference(q, k_pool, v_pool, block_tables, *args,
                                   **kw)

    def plain_forward(attention):
        kv = BlockedKVCache(cfg.num_hidden_layers, n_pages, bs,
                            cfg.num_key_value_heads, cfg.head_dim, "bf16",
                            device="cuda")
        return ragged_forward(
            model, kv, arrays["tokens"], arrays["q_len"], arrays["seen"],
            arrays["block_tables"], attention=attention)[0].cpu().numpy()

    plain_logits = plain_forward(paged_mha_reference)
    control_logits = plain_forward(faulty_attention)

    def rel_l2(x):
        return float(np.linalg.norm(x - plain_logits)
                     / np.linalg.norm(plain_logits))

    logit_err, control_err = rel_l2(kernel_logits), rel_l2(control_logits)
    print(f"serving: first-token logits vs the plain-attention forward, "
          f"relative L2 error: kernel {logit_err:.4g}, control with page "
          f"{LOGITS_FAULT_PAGE} faulted {control_err:.4g} (tolerance "
          f"{LOGITS_REL_L2_TOLERANCE}); max abs err "
          f"{float(np.abs(kernel_logits - plain_logits).max()):.4g} of max "
          f"|logit| {float(np.abs(plain_logits).max()):.4g}; argmax "
          f"{kernel_logits.argmax()} vs {plain_logits.argmax()}", flush=True)
    if not np.isfinite(kernel_logits).all():
        fail("kernel-backed logits are not finite")
    if not logit_err <= LOGITS_REL_L2_TOLERANCE:
        fail(f"first-token logits disagree: {logit_err} > "
             f"{LOGITS_REL_L2_TOLERANCE}")
    if not control_err > LOGITS_REL_L2_TOLERANCE:
        fail(f"the logits bound does not reject the page-fault control: "
             f"{control_err} <= {LOGITS_REL_L2_TOLERANCE}")
    if kernel_logits.argmax() != plain_logits.argmax():
        fail("first-token argmax differs between kernel and plain attention")

    # SplitFuse serving of 8 greedy requests
    sched = SplitFuseScheduler(engine)
    lens = rng.integers(64, 1501, 8)
    n_new = 64
    for uid, n in enumerate(lens):
        sched.submit(uid, rng.integers(0, cfg.vocab_size, int(n)),
                     max_new_tokens=n_new)
    torch.cuda.synchronize()
    paged_mha.launches = 0
    syncs0 = engine.host_sync_count
    ttft, round_ms, decode_ms = {}, [], []
    t_start = time.perf_counter()
    rounds = 0
    while sched.has_work:
        # a request has no token until its prompt is fully prefilled
        decode_only = all(len(t) for t in sched.results().values())
        t = time.perf_counter()
        sched.step()
        dt = time.perf_counter() - t
        rounds += 1
        round_ms.append(dt * 1e3)
        if decode_only:
            decode_ms.append(dt * 1e3)
        for uid, toks in sched.results().items():
            if len(toks) and uid not in ttft:
                ttft[uid] = time.perf_counter() - t_start
        if rounds > 2000:
            fail("scheduler did not converge")
    wall = time.perf_counter() - t_start
    launches = paged_mha.launches
    forwards = engine.host_sync_count - syncs0
    results = sched.results()
    for uid, toks in results.items():
        if len(toks) != n_new or toks.min() < 0 or toks.max() >= cfg.vocab_size:
            fail(f"request {uid} finished with bad tokens {toks[:8]}...")
    if launches == 0 or launches != cfg.num_hidden_layers * forwards:
        fail(f"paged_mha launched {launches} times, expected "
             f"{cfg.num_hidden_layers} x {forwards} forwards")
    stats = dict(requests=len(results), prompt_tokens=int(lens.sum()),
                 new_tokens=n_new * len(results), rounds=rounds,
                 forwards=forwards, wall_s=wall,
                 tokens_per_s=n_new * len(results) / wall,
                 median_decode_round_ms=float(np.median(decode_ms)),
                 median_ttft_s=float(np.median(list(ttft.values()))),
                 max_ttft_s=max(ttft.values()),
                 paged_mha_launches=launches,
                 peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    print(f"serving {json.dumps(stats)}", flush=True)
    return launches


def main():
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device: this script runs the port on the GPU")
    if not (REPO / "deepspeed_tpu_torch" / "csrc").is_dir():
        fail(f"no deepspeed_tpu_torch sources beside {__file__}")
    sys.path.insert(0, str(REPO))
    from deepspeed_tpu_torch.ops import cuda_build

    smi = nvidia_smi()
    print(f"device: {smi}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    t0 = time.perf_counter()
    logs = cuda_build.build("paged_attention", verbose=True)
    print(f"kernel build: {time.perf_counter() - t0:.1f}s", flush=True)
    for name, log in logs.items():
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
        spills = sum(int(b) for b in re.findall(r"(\d+) bytes spill stores", log))
        print(f"  {name}: {len(regs)} kernels, max {max(regs, default=0)} "
              f"registers/thread, {spills} bytes of spill stores", flush=True)
    t1 = time.perf_counter()
    cases = phase_kernels()
    print(f"phase kernels: {time.perf_counter() - t1:.1f}s", flush=True)
    t2 = time.perf_counter()
    launches = phase_serving()
    print(f"phase serving: {time.perf_counter() - t2:.1f}s", flush=True)

    main_case = cases[0]   # decode_7b: the shape of the serving main path
    kernels = [dict(
        name="paged_mha", route="cuda",
        source="deepspeed_tpu_torch/csrc/paged_attention.cu",
        replaces="deepspeed_tpu/ops/pallas/paged_attention.py:222",
        launches=launches,
        max_abs_err=main_case["max_abs_err"],
        ms=main_case["ms"], plain_ms=main_case["plain_ms"],
        bound_ms=main_case["bound_ms"], bound_by=main_case["bound_by"],
        library_ms=main_case["library_ms"], case=main_case["name"],
        cases=[{k: c[k] for k in ("name", "max_abs_err", "err_ratio", "ms",
                                  "plain_ms", "library_ms", "bound_ms",
                                  "bound_by")}
               for c in cases])]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
