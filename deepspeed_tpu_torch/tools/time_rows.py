"""Times kernel rows 1 (paged attention) and 7 (W8A16 dequantize-matmul) at
the serving shapes of Llama-2-7B and Mixtral-8x7B (row 1 also at those of
Mistral-7B's window, Falcon-7B and Phi-2, and at a tensor-parallel rank's
heads of Llama-2-7B and Mixtral-8x7B at tp 2), rows 5 and 6 (the qgZ
quantize and dequantize-reduce) at the four leaf shapes of ZeRO-3 + qgZ
training of Llama-2-7B at W = 4, and row 9a (the grouped GEMM forward) at
Mixtral-8x7B's expert width at tp 2, through their public entry points, on
one GPU.

    python3 deepspeed_tpu_torch/tools/time_rows.py [--root DIR] [--iters 50]
        [--rows 1,7,5,6,9a]

The cases, their inputs and the timers are those of this checkout's
``chip_smoke.py`` (``CASES`` and ``make_case``, ``QMM_CASES`` and
``qmm_inputs``, ``time_ms`` and ``device_ms``), drawn from fixed seeds.
``--root`` imports ``deepspeed_tpu_torch`` from another checkout (for
example the parent commit unpacked under ``build/``), so that two versions
are timed by the same script on the same inputs and card: run parent,
change, change, parent. Row 7's weights rotate past the L2 cache. Rows 5
and 6 take ``QUANT_CASES`` of ``chip_smoke.py`` (its inputs drawn the same
way) at the ``gate_proj``, embedding, attention-projection and norm
chunks, the quantize kernel on the payload rows and the dequantize-reduce
kernel on the wire they give. Row 9a takes the ``_tp2`` cases of
``GMM_CASES`` (``gmm_rows`` routing). Rows 1 and 9a also give the bound
(``work`` and the bytes and operations of ``phase_gmm_kernels``, over the
H100's 3.35 TB/s and dtype peak) and the library call's time
(``library_call``, ``gmm_library``). ``--rows`` picks the rows. Prints one JSON
line: the card (name and power limit), the root, and for each
case the milliseconds per call of the stream (CUDA events around
back-to-back calls: where the host enqueues a call more slowly than the
card runs it, this is the host's time), the host's microseconds to
enqueue a call (the wrapper's checks, allocations and library call, read
by the host's clock over back-to-back calls that do not wait for the
card) and the device time per call of the row's kernels, their
split-merging passes included (``torch.profiler``, kernel names holding
``paged_mha``, or ``quantized_matmul`` / ``split_reduce``, or
``quantize_`` / ``dequant_reduce``, or ``grouped_gemm``). Needs a CUDA device.
"""

import argparse
import importlib.util
import itertools
import json
import sys
import time
from pathlib import Path

HARNESS = Path(__file__).resolve().parents[2] / "chip_smoke.py"
PAGED = ("decode_7b", "decode_serve_7b", "decode_serve_8x7b", "prefill_chunk_7b",
         "mixed_chunk_decode_7b", "decode_serve_mistral_window", "decode_serve_falcon_7b",
         "decode_serve_phi_2", "prefill_chunk_phi_2", "decode_serve_7b_tp2",
         "decode_serve_8x7b_tp2")
QMM = ("decode_7b_gate", "decode_7b_down", "decode_7b_q", "prefill_7b_gate",
       "prefill_7b_down")
QUANT = ("gate_proj_chunk", "embedding_chunk", "attn_proj_chunk", "norm_chunk")
GMM = ("decode_8x7b_tp2", "mixed_round_8x7b_tp2", "w2_decode_8x7b_tp2",
       "w2_mixed_8x7b_tp2")


def host_us(fn, iters):
    """Host microseconds per call over ``iters`` back-to-back calls, timed
    without waiting for the card (fewer calls than fill its launch queue)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    dt = time.perf_counter() - t
    torch.cuda.synchronize()
    return dt / iters * 1e6


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(HARNESS.parent))
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--rows", default="1,7,5,6,9a",
                    help="kernel rows to time, of 1, 7, 5, 6, 9a")
    args = ap.parse_args(argv)
    rows = set(args.rows.split(","))
    sys.path.insert(0, args.root)
    spec = importlib.util.spec_from_file_location("chip_smoke", HARNESS)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("time_rows: no CUDA device")
    from deepspeed_tpu_torch.ops import cuda_build
    cuda_build.build("paged_attention", "quantized_matmul", "quant_collective",
                     "grouped_gemm")
    from deepspeed_tpu_torch.ops import quant_collective as qc
    from deepspeed_tpu_torch.ops.grouped_gemm import grouped_matmul
    from deepspeed_tpu_torch.ops.paged_attention import paged_mha
    from deepspeed_tpu_torch.ops.quantized_matmul import quantized_matmul

    result = {"device": smoke.nvidia_smi(), "root": args.root}
    for row, k in (("1", "paged_mha"), ("7", "quantized_matmul"), ("5", "block_quantize"),
                   ("6", "block_dequantize_reduce"), ("9a", "grouped_matmul")):
        if row in rows:
            result.update({f"{k}_{what}": {} for what in ("ms", "device_ms", "host_us")})
            if row in ("1", "9a"):
                result.update({f"{k}_{what}": {} for what in ("bound_ms", "library_ms")})
    for i, case in enumerate(c for c in smoke.CASES if c[0] in PAGED and "1" in rows):
        a = smoke.make_case(case, torch.Generator(device="cuda").manual_seed(i),
                            np.random.default_rng(i))
        call = lambda: paged_mha(a["q"], a["k_pool"], a["v_pool"], a["block_tables"],
                                 a["seen"], a["q_len"], window=a["window"])
        result["paged_mha_ms"][case[0]] = smoke.time_ms(call, args.iters)
        result["paged_mha_host_us"][case[0]] = host_us(call, args.iters)
        result["paged_mha_device_ms"][case[0]] = smoke.device_ms(call, args.iters,
                                                                 ("paged_mha",))
        nbytes, ops = smoke.work(case, a)
        result["paged_mha_bound_ms"][case[0]] = max(
            nbytes / smoke.HBM_BYTES_PER_S, ops / smoke.PEAK_FLOPS[case[7]]) * 1e3
        result["paged_mha_library_ms"][case[0]] = None if case[8] else smoke.time_ms(
            lambda: smoke.library_call(a), args.iters)
        del a
    gen = torch.Generator(device="cuda").manual_seed(7)
    for case in (c for c in smoke.QMM_CASES if c[0] in QMM and "7" in rows):
        name, M, K, N, G = case[:5]
        x, q, s = smoke.qmm_inputs(case, gen)
        ws = itertools.cycle([(q.clone(), s.clone()) for _ in range(smoke.qmm_copies(K, N))])
        iters = args.iters if M <= 16 else 10
        call = lambda: quantized_matmul(x, *next(ws), G)
        result["quantized_matmul_ms"][name] = smoke.time_ms(call, iters)
        result["quantized_matmul_host_us"][name] = host_us(call, iters)
        result["quantized_matmul_device_ms"][name] = smoke.device_ms(
            call, iters, ("quantized_matmul", "split_reduce"))
        del x, q, s, ws
        torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(10)
    for name, P, m, bits, dtype in (c for c in smoke.QUANT_CASES
                                    if c[0] in QUANT and rows & {"5", "6"}):
        x = torch.randn(P, m, generator=gen, device="cuda")
        x[0, :smoke.QUANT_GROUP] *= 100.0
        x = x.to(getattr(torch, dtype))
        gs = smoke.QUANT_GROUP
        q, s = qc.block_quantize(x, num_bits=bits, group_size=gs)
        iters = args.iters if m < 10_000_000 else 20
        for row, key, call, names in (
                ("5", "block_quantize", lambda: qc.block_quantize(x, num_bits=bits,
                                                                  group_size=gs),
                 ("quantize_",)),
                ("6", "block_dequantize_reduce",
                 lambda: qc.block_dequantize_reduce(q, s, num_bits=bits, group_size=gs,
                                                    out_len=m),
                 ("dequant_reduce",))):
            if row not in rows:
                continue
            result[f"{key}_ms"][name] = smoke.time_ms(call, iters)
            result[f"{key}_host_us"][name] = host_us(call, iters)
            result[f"{key}_device_ms"][name] = smoke.device_ms(call, iters, names)
        del x, q, s
        torch.cuda.empty_cache()
    rng = np.random.default_rng(9)
    gen = torch.Generator(device="cuda").manual_seed(9)
    for name, R, K, N, E, dtype, routing in (c for c in smoke.GMM_CASES
                                             if c[0] in GMM and "9a" in rows):
        offs = smoke.gmm_offsets(smoke.gmm_rows(R, E, routing, rng), E)
        dt = getattr(torch, dtype)
        xs = torch.randn(R, K, generator=gen, device="cuda").to(dt)
        w = (torch.randn(E, K, N, generator=gen, device="cuda") * K ** -0.5).to(dt)
        offsets = torch.from_numpy(offs).to("cuda")
        call = lambda: grouped_matmul(xs, w, offsets)
        iters = args.iters if R <= 1024 else 10
        result["grouped_matmul_ms"][name] = smoke.time_ms(call, iters)
        result["grouped_matmul_host_us"][name] = host_us(call, iters)
        result["grouped_matmul_device_ms"][name] = smoke.device_ms(call, iters, ("grouped_gemm",))
        touched = int((np.diff(offs) > 0).sum())
        nbytes = (R * K + R * N + touched * K * N) * xs.element_size() + offs.nbytes
        result["grouped_matmul_bound_ms"][name] = max(
            nbytes / smoke.HBM_BYTES_PER_S, 2 * R * K * N / smoke.PEAK_FLOPS[dtype]) * 1e3
        lib, lib_name = smoke.gmm_library(xs, w, offsets)
        result["grouped_matmul_library_ms"][name] = {lib_name: smoke.time_ms(lib, iters)}
        del xs, w, offsets, lib
        torch.cuda.empty_cache()
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
