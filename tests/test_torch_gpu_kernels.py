"""The port's CUDA kernels against their plain PyTorch versions, on the GPU.

The tests marked ``gpu`` need a CUDA device: the hand-written kernels have
no CPU mode, so on a host without one they skip with that reason. The
unmarked tests check the comparisons' bounds with the plain versions alone.
This file imports neither JAX nor the JAX package, so it also runs where
only PyTorch is installed: ``python -m pytest tests/test_torch_gpu_kernels.py
--noconftest``.

Tolerance, per element: |kernel - plain| <= ATOL + RTOL * |plain|. Kernel
and plain version both compute in fp32 from the same inputs and differ only
in summation order before the final rounding to the output dtype, which
moves a value by at most one unit in its last place: 2^-7 of it in bf16,
2^-10 in fp16; fp32 outputs are not rounded again. ATOL covers the fp32
summation-order noise of elements near 0. A one-page fault exceeds the bound
by two orders of magnitude (``test_bound_rejects_one_page_fault``). The
paged kernel (both routes: bf16/fp16 q with fp pools) rounds p to v's
dtype before P.V as the TPU kernel does, where the plain version keeps p in
fp32: its bound adds ``paged_flip_slack`` (``tests/flash_rounding.py``), and
``paged_probe`` holds its rounding point with no slack. The flash attention and grouped-GEMM kernels' bound is stated
beside their tests below.
"""

from unittest import mock

import numpy as np
import pytest
import torch
from flash_rounding import (dkv_probe, dkv_probe_value, dkv_rounding_faults,
                            dkv_split_product, dq_probe, dq_rounding_faults, flip_slack,
                            fwd_probe, fwd_rounding_faults, paged_flip_slack, paged_probe,
                            paged_rounding_faults, sparse_flip_slack, sparse_probe,
                            sparse_rounding_faults)

from deepspeed_tpu_torch.ops import paged_attention as pa
from deepspeed_tpu_torch.ops.paged_attention import paged_mha, paged_mha_reference

gpu = pytest.mark.gpu

ATOL = 2e-5
RTOL = {torch.bfloat16: 2 ** -7, torch.float16: 2 ** -10, torch.float32: 2 ** -16}


def err_ratio(out, ref, slack=0.0):
    """Largest |out - ref| / (ATOL + RTOL * |ref| + slack): at most 1
    passes."""
    bound = ATOL + RTOL[ref.dtype] * ref.float().abs() + slack
    return ((out.float() - ref.float()).abs() / bound).max().item()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernel has no CPU mode")
    return torch.device("cuda")


def make_case(dev, S=3, Q=1, H=8, KV=2, Dh=64, bs=16, MB=6, dtype=torch.bfloat16,
              int8=False, seed=0, q_len=None):
    g = torch.Generator(device=dev).manual_seed(seed)
    NB = S * MB + 1
    q = torch.randn(S, Q, H, Dh, generator=g, device=dev).to(dtype)
    if int8:
        k = torch.randint(-127, 128, (NB, KV, bs, Dh), generator=g, device=dev,
                          dtype=torch.int8)
        v = torch.randint(-127, 128, (NB, KV, bs, Dh), generator=g, device=dev,
                          dtype=torch.int8)
        ks = 0.005 + 0.01 * torch.rand(NB, KV, 1, bs, generator=g, device=dev)
        vs = 0.005 + 0.01 * torch.rand(NB, KV, 1, bs, generator=g, device=dev)
    else:
        k = torch.randn(NB, KV, bs, Dh, generator=g, device=dev).to(dtype)
        v = torch.randn(NB, KV, bs, Dh, generator=g, device=dev).to(dtype)
        ks = vs = None
    bt = torch.randperm(NB - 1, generator=g, device=dev)[:S * MB]
    bt = bt.reshape(S, MB).int()
    seen = torch.randint(0, MB * bs - Q, (S,), generator=g, device=dev).int()
    ql = torch.full((S,), Q, device=dev, dtype=torch.int32) if q_len is None \
        else torch.tensor(q_len, device=dev, dtype=torch.int32)
    return (q, k, v, bt, seen, ql), dict(k_scale=ks, v_scale=vs)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
def test_bound_rejects_one_page_fault(dtype):
    """The bound passes a plain output moved by one unit in its last place and
    rejects one that read the wrong page: the first page of sequence 0
    replaced by one that no table holds."""
    args, kw = make_case(torch.device("cpu"), Q=8, dtype=dtype)
    ref = paged_mha_reference(*args, **kw)
    x = ref.float()
    ulp = torch.finfo(dtype).eps * torch.exp2(torch.floor(torch.log2(x.abs())))
    assert err_ratio((x + ulp).to(dtype), ref) <= 1
    q, k, v, bt, seen, ql = args
    bt = bt.clone()
    bt[0, 0] = k.shape[0] - 1
    assert err_ratio(paged_mha_reference(q, k, v, bt, seen, ql, **kw), ref) > 10


def check_paged_kernel(args, kw, window=None):
    """One call of the paged kernel on the card: the route the source
    declares by the tally, the plain version within the bound (plus
    paged_flip_slack where the kernel rounds p), and beyond it a one-page
    fault: the trash page read in place of the page holding key seen[0],
    which query token 0 of sequence 0 sees under any window."""
    q, k, v, bt, seen, ql = args
    want = pa.kernel_route(q.dtype, kw["k_scale"] is not None, q.shape[-1], k.shape[2])
    before, tally = paged_mha.launches, pa.kernel_launches()
    out = paged_mha(*args, window=window, **kw)
    after = pa.kernel_launches()
    assert paged_mha.launches == before + 1
    assert {n: after[n] - tally[n] for n in after if after[n] > tally[n]} == {want: 1}
    ref = paged_mha_reference(*args, window=window, **kw)
    slack = (paged_flip_slack(*args, window=window)
             if pa.rounds_p(q.dtype, kw["k_scale"] is not None) else 0.0)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    assert err_ratio(out, ref, slack) <= 1
    bad_bt = bt.clone()
    bad_bt[0, int(seen[0]) // k.shape[2]] = k.shape[0] - 1
    bad = paged_mha_reference(q, k, v, bad_bt, seen, ql, window=window, **kw)
    assert err_ratio(bad, ref, slack) > 1
    return out, ref


@gpu
@pytest.mark.parametrize("Q", [1, 8, 33])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("H,KV", [(8, 2), (4, 4)], ids=["gqa", "mha"])
def test_kernel_matches_plain(cuda, Q, dtype, H, KV):
    args, kw = make_case(cuda, Q=Q, H=H, KV=KV, dtype=dtype, seed=Q)
    check_paged_kernel(args, kw)


@gpu
@pytest.mark.parametrize("window", [5, 40])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("Dh", [16, 128, 256])
def test_kernel_window_int8_head_dims(cuda, window, int8, Dh):
    args, kw = make_case(cuda, Q=8, Dh=Dh, int8=int8, seed=Dh)
    check_paged_kernel(args, kw, window)


@gpu
@pytest.mark.parametrize("bs", [16, 32, 128])
@pytest.mark.parametrize("S,Q", [(2, 1), (3, 20)])
def test_kernel_block_sizes_and_splits(cuda, bs, S, Q):
    """The tensor-core route at every block size it takes, long enough for
    key splits at decode (one sequence of one kv head: the split count is
    the block table's width in key tiles over two)."""
    args, kw = make_case(cuda, S=S, Q=Q, H=4, KV=1, Dh=64, bs=bs, MB=1024 // bs, seed=bs)
    check_paged_kernel(args, kw)
    check_paged_kernel(args, kw, window=300)


@gpu
def test_kernel_zero_rows(cuda):
    args, kw = make_case(cuda, S=4, Q=8, q_len=[8, 0, 3, 1])
    out, ref = check_paged_kernel(args, kw)
    assert not out[1].any() and not out[2, 3:].any() and not out[3, 1:].any()


@gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("bs,Q,rep", [(64, 1, 1), (16, 16, 4), (32, 8, 2)])
def test_paged_kernel_rounds_where_the_tpu_kernel_does(cuda, dh, bs, Q, rep, dtype):
    """On ``paged_probe`` the tensor-core kernel (two key splits at Q 1)
    equals the kernel form with no slack, and p unrounded or in the other
    16-bit type fails that bound."""
    args, kw = paged_probe(dtype, dh, bs, cuda, Q=Q, rep=rep)
    tally = pa.kernel_launches()["wgmma"]
    out = paged_mha(*args, **kw)
    assert pa.kernel_launches()["wgmma"] == tally + 1
    ref = pa.paged_mha_kernel_form(*args, **kw)
    torch.cuda.synchronize()
    assert err_ratio(out, ref) <= 1
    assert all(err_ratio(bad, ref) > 1 for bad in paged_rounding_faults(*args, **kw).values())


@gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("dh", [80, 96, 256])
@pytest.mark.parametrize("bs,Q,rep", [(64, 1, 1), (16, 16, 4), (32, 8, 2)])
def test_simt_paged_kernel_rounds_where_the_tpu_kernel_does(cuda, dh, bs, Q, rep, dtype):
    """The SIMT route (head widths other than 64 and 128: Phi-2's 80) rounds
    p to v's dtype before P.V for bf16/fp16 pools, as the TPU kernel does:
    on ``paged_probe`` it equals the kernel form with no slack, and p
    unrounded (the route before the repair) or in the other 16-bit type
    fails that bound."""
    args, kw = paged_probe(dtype, dh, bs, cuda, Q=Q, rep=rep)
    assert pa.kernel_route(dtype, False, dh, bs) == "simt"
    tally = pa.kernel_launches()["simt"]
    out = paged_mha(*args, **kw)
    assert pa.kernel_launches()["simt"] == tally + 1
    ref = pa.paged_mha_kernel_form(*args, **kw)
    torch.cuda.synchronize()
    assert err_ratio(out, ref) <= 1
    assert all(err_ratio(bad, ref) > 1 for bad in paged_rounding_faults(*args, **kw).values())


@gpu
@pytest.mark.parametrize("case", ["decode", "decode_bucket", "prefill_chunk"])
def test_kernel_at_falcon_7b_rep_71(cuda, case):
    """Falcon-7B's heads on the tensor cores: 71 query heads of width 64 on
    one kv head, so an item's 71 x Q rows span two or more 64-row tiles, the
    last one partly live. Such items are never split (``split_count``: more
    than one row tile), at any context length."""
    S, Q, q_len, MB = {"decode": (8, 1, None, 40), "decode_bucket": (8, 8, [1] * 8, 40),
                       "prefill_chunk": (2, 64, [64, 37], 24)}[case]
    args, kw = make_case(cuda, S=S, Q=Q, H=71, KV=1, Dh=64, bs=64, MB=MB, seed=71 + Q,
                         q_len=q_len)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert pa.split_count(S, Q, 71, 1, 64, MB, sms) == 1
    assert pa.kernel_route(torch.bfloat16, False, 64, 64) == "wgmma"
    check_paged_kernel(args, kw)


@gpu
@pytest.mark.parametrize("case", ["decode", "decode_bucket", "prefill_chunk"])
@pytest.mark.parametrize("H,KV", [(16, 16), (16, 4)], ids=["llama2_7b_tp2", "mixtral_tp2"])
def test_kernel_at_tensor_parallel_heads(cuda, H, KV, case):
    """One tensor-parallel rank's heads at tp 2: Llama-2-7B's 16 query heads
    on 16 kv heads, Mixtral-8x7B's 16 on 4, width 128, pages of 64, on the
    tensor cores; decode rounds with key splits."""
    S, Q, q_len, MB = {"decode": (8, 1, None, 32), "decode_bucket": (8, 8, [1] * 8, 32),
                       "prefill_chunk": (2, 256, [256, 200], 24)}[case]
    args, kw = make_case(cuda, S=S, Q=Q, H=H, KV=KV, Dh=128, bs=64, MB=MB, seed=H * KV + Q,
                         q_len=q_len)
    assert pa.kernel_route(torch.bfloat16, False, 128, 64) == "wgmma"
    check_paged_kernel(args, kw)


@gpu
@pytest.mark.parametrize("case", ["decode", "decode_bucket", "prefill_chunk"])
@pytest.mark.parametrize("H,KV,Dh", [(36, 1, 64), (35, 1, 64), (16, 16, 80), (16, 16, 128)],
                         ids=["falcon_7b_tp2_r0", "falcon_7b_tp2_r1", "phi_2_tp2",
                              "opt_6_7b_tp2"])
def test_kernel_at_tensor_parallel_family_heads(cuda, H, KV, Dh, case):
    """A tensor-parallel rank's heads at tp 2 for the families served since
    A5 part 2: Falcon-7B's 71 query heads of 64 cut 36 / 35, each rank on a
    copy of the one kv head (tensor cores), Phi-2's 16 heads of 80 (the
    SIMT route), OPT-6.7B's 16 heads of 128; pages of 64."""
    S, Q, q_len, MB = {"decode": (8, 1, None, 32), "decode_bucket": (8, 8, [1] * 8, 32),
                       "prefill_chunk": (2, 64, [64, 37], 24)}[case]
    args, kw = make_case(cuda, S=S, Q=Q, H=H, KV=KV, Dh=Dh, bs=64, MB=MB, seed=H + Dh + Q,
                         q_len=q_len)
    assert pa.kernel_route(torch.bfloat16, False, Dh, 64) == ("simt" if Dh == 80 else "wgmma")
    check_paged_kernel(args, kw)


@gpu
@pytest.mark.parametrize("S,Q", [(4, 1), (8, 8), (2, 48)])
def test_kernel_window_4096_past_the_window(cuda, S, Q):
    """Mistral-7B's attention (32 heads of 128 over 8 kv heads, pages of 64)
    with its 4096-key sliding window, every context past it: the first
    visible key moves off the first page, and decode rounds split the keys
    (up to MAX_SPLITS)."""
    args, kw = make_case(cuda, S=S, Q=Q, H=32, KV=8, Dh=128, bs=64, MB=72, seed=4096 + Q)
    seen = args[4]
    seen.copy_(torch.randint(4100, 72 * 64 - Q, (S,), device=cuda, dtype=torch.int32))
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    if Q == 1:
        assert pa.split_count(S, Q, 32, 8, 64, 72, sms) > 1
    check_paged_kernel(args, kw, window=4096)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("bs,Q,rep", [(64, 1, 1), (16, 16, 4)])
def test_paged_probe_rejects_rounding_point_faults(dtype, bs, Q, rep):
    """On ``paged_probe`` the kernel form's output is exactly 0 off every
    8th column, and p unrounded or rounded to the other 16-bit type fails
    the bound by fivefold or more."""
    args, kw = paged_probe(dtype, 64, bs, torch.device("cpu"), Q=Q, rep=rep)
    form = pa.paged_mha_kernel_form(*args, **kw)
    assert not form[..., torch.arange(64) % 8 != 0].any()
    assert form[..., ::8].abs().min() > 0
    for fault, bad in paged_rounding_faults(*args, **kw).items():
        assert err_ratio(bad, form) > 4, fault


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("Q,H,KV,window", [(1, 8, 2, None), (8, 4, 4, None),
                                           (33, 8, 2, 40)])
def test_paged_flip_slack_admits_the_kernel_form(dtype, Q, H, KV, window):
    """p rounded to v's dtype (the kernel form, as the TPU kernel and the
    tensor-core kernel round it) lies within ATOL + RTOL |plain| plus
    ``paged_flip_slack`` of the fp32-p plain version, and not within the
    bound alone; a one-page fault stays beyond the bound with the slack."""
    args, kw = make_case(torch.device("cpu"), Q=Q, H=H, KV=KV, dtype=dtype, seed=Q)
    ref = paged_mha_reference(*args, window=window)
    form = pa.paged_mha_kernel_form(*args, window=window)
    slack = paged_flip_slack(*args, window=window)
    assert err_ratio(form, ref) > 1
    assert err_ratio(form, ref, slack) <= 1
    q, k, v, bt, seen, ql = args
    bad_bt = bt.clone()
    bad_bt[0, 0] = k.shape[0] - 1
    assert err_ratio(paged_mha_reference(q, k, v, bad_bt, seen, ql, window=window), ref,
                     slack) > 10


def split_merge(args, splits, window=None):
    """A plain emulation of the tensor-core kernel's key splits, p in fp32:
    each (sequence, kv head) item's key tiles cut by ``pa.split_ranges`` at
    boundaries of the block table's width,
    each split's online softmax over 64-key tiles from m = NEG_INF (an empty
    split leaves m = -inf, l = 0), then the combine in split order: out =
    sum w_s o_s / sum w_s l_s, w_s = exp(m_s - max m), splits with l = 0
    skipped, rows past q_len 0."""
    q, k, v, bt, seen, ql = args
    S, Q, H, Dh = q.shape
    KV, bs = k.shape[1], k.shape[2]
    rep, T = H // KV, pa.KEY_TILE
    key_tiles = -(-bt.shape[1] * bs // T)
    keys = k[bt.long()].float().permute(0, 2, 1, 3, 4).reshape(S, KV, -1, Dh)
    vals = v[bt.long()].float().permute(0, 2, 1, 3, 4).reshape(S, KV, -1, Dh)
    out = torch.zeros(S, Q, H, Dh)
    for s in range(S):
        for h in range(KV):
            ranges = pa.split_ranges(int(seen[s]), int(ql[s]), Q, rep, window, splits,
                                     key_tiles)
            for g in range(rep * Q):
                qi, head = g % Q, h * rep + g // Q
                if qi >= ql[s]:
                    continue
                qpos = int(seen[s]) + qi
                parts = []
                for first, end in ranges:
                    m, l, o = float("-inf"), 0.0, torch.zeros(Dh)
                    if first < end:
                        m = pa.NEG_INF
                    for t in range(first, end):
                        kpos = torch.arange(t * T, (t + 1) * T)
                        kt = torch.nn.functional.pad(keys[s, h], (0, 0, 0, T))[kpos]
                        vt = torch.nn.functional.pad(vals[s, h], (0, 0, 0, T))[kpos]
                        x = kt @ q[s, qi, head].float() * Dh ** -0.5
                        vis = kpos <= qpos
                        if window:
                            vis &= kpos > qpos - window
                        x = torch.where(vis, x, pa.NEG_INF)
                        m_new = max(m, float(x.max()))
                        alpha = torch.exp(torch.tensor(m - m_new))
                        p = torch.exp(x - m_new)
                        l, o, m = float(alpha * l + p.sum()), o * alpha + p @ vt, m_new
                    parts.append((m, l, o))
                mx = max(m for m, l, _ in parts if l > 0)
                w = [float(torch.exp(torch.tensor(m - mx))) if l > 0 else 0.0
                     for m, l, _ in parts]
                num = sum(wi * o for wi, (_, l, o) in zip(w, parts) if l > 0)
                out[s, qi, head] = num / sum(wi * l for wi, (_, l, _) in zip(w, parts))
    return out


@pytest.mark.parametrize("Q,window", [(1, None), (8, None), (16, 24)])
def test_split_and_combine_equals_the_unsplit_form(Q, window):
    """1-4 key splits merged as the kernel merges them equal the unsplit
    online softmax within fp32 summation error, with splits that see no
    visible key (a chunk's early rows against a split of later keys) and
    empty splits (more splits than key tiles); the ranges cover every tile
    of the item exactly once."""
    args, _ = make_case(torch.device("cpu"), S=3, Q=Q, H=4, KV=2, Dh=32, bs=16, MB=12,
                        dtype=torch.float32, seed=Q)
    q, k, v, bt, seen, ql = args
    seen[0] = 3          # one key tile: later splits are empty
    one = split_merge(args, 1, window)
    ref = paged_mha_reference(*args, window=window)
    assert (one - ref).abs().max() <= 1e-5
    for splits in (2, 3, 4):
        for s in range(3):
            ranges = pa.split_ranges(int(seen[s]), int(ql[s]), Q, 2, window, splits, 12)
            tiles = [t for a, b in ranges for t in range(a, b)]
            assert tiles == list(range(ranges[0][0], ranges[-1][1]))
        assert (split_merge(args, splits, window) - one).abs().max() <= 1e-5


def test_split_ranges_do_not_depend_on_the_other_rows():
    """A decode row at position p and column j of a 5-token verify chunk at
    the same position see the same key tiles in every split: the splits are
    cut at tile boundaries fixed by the block table's width, so the other
    live rows of the chunk only add tiles past p (exact zeros for this row)
    or splits wholly past p (weight 0 in the combine). Cut from the chunk's
    own last key, as before, the boundaries moved with j."""
    Q, key_tiles = 8, 32
    for splits in (1, 2, 5, 16):
        for p in range(key_tiles * pa.KEY_TILE - 4):
            decode = pa.split_ranges(p, 1, Q, 1, None, splits, key_tiles)
            mine = [[t for t in range(a, b) if t <= p // pa.KEY_TILE] for a, b in decode]
            for j in range(5):
                if p - j < 0:
                    continue
                verify = pa.split_ranges(p - j, 5, Q, 1, None, splits, key_tiles)
                assert [[t for t in range(a, b) if t <= p // pa.KEY_TILE]
                        for a, b in verify] == mine
                # tiles the verify chunk adds lie past the row's last key
                extra = {t for a, b in verify for t in range(a, b)} - \
                    {t for a, b in decode for t in range(a, b)}
                assert all(t * pa.KEY_TILE > p for t in extra)


def verify_column_cases(dev, S, MB, seed=0, H=32, KV=32, Dh=128):
    """Calls of the paged kernel at Llama-2-7B attention width (32 heads of
    128, bs 64, bf16, Q 8; or ``H`` heads of ``Dh`` over ``KV``) on one set
    of pools: for each position p and column j < 5, sequence 0 as a decode
    row at p and as a 5-token verify chunk whose column j sits at p, with
    the same query at p. Where p is 2 or 3 short of a 64-key tile boundary,
    the chunk's last key lies one tile past the decode row's."""
    g = torch.Generator(device=dev).manual_seed(seed)
    bs, Q = 64, 8
    NB = S * MB + 1
    k = torch.randn(NB, KV, bs, Dh, generator=g, device=dev).to(torch.bfloat16)
    v = torch.randn(NB, KV, bs, Dh, generator=g, device=dev).to(torch.bfloat16)
    bt = torch.randperm(NB - 1, generator=g, device=dev)[:S * MB].reshape(S, MB).int()
    seen = torch.randint(0, MB * bs - Q, (S,), generator=g, device=dev).int()
    ql = torch.ones(S, device=dev, dtype=torch.int32)
    # positions 2 and 3 short of a key-tile boundary: the verify chunk's
    # keys reach into the next tile, the decode row's do not
    for p in sorted({5, 62, 64 * max(1, MB // 3) - 3, 64 * (MB // 2) - 2, MB * bs - 9}):
        for j in range(min(5, p + 1)):
            q_dec = torch.randn(S, Q, H, Dh, generator=g, device=dev).to(torch.bfloat16)
            q_ver = torch.randn(S, Q, H, Dh, generator=g, device=dev).to(torch.bfloat16)
            seen_dec, seen_ver, ql_ver = seen.clone(), seen.clone(), ql.clone()
            seen_dec[0], seen_ver[0], ql_ver[0] = p, p - j, 5
            q_ver[0, j] = q_dec[0, 0]
            yield p, j, (q_dec, k, v, bt, seen_dec, ql), (q_ver, k, v, bt, seen_ver, ql_ver)


@gpu
@pytest.mark.parametrize("S,MB,split", [(40, 32, False), (8, 2, False), (8, 32, True),
                                        (4, 64, True)])
def test_decode_row_and_verify_column_are_bitwise_equal(cuda, S, MB, split):
    """The paged kernel's output for a query row does not depend on the
    other live rows of its tile: a decode row at position p and column j of
    a 5-token verify chunk at p give bitwise equal outputs, with one key
    split and with several (the speculative oracle: a greedy verify column
    must read exactly what plain decode reads)."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert (pa.split_count(S, 8, 32, 32, 64, MB, sms) > 1) == split
    assert pa.kernel_route(torch.bfloat16, False, 128, 64) == "wgmma"
    for p, j, dec, ver in verify_column_cases(cuda, S, MB, seed=S + MB):
        out_dec, out_ver = paged_mha(*dec), paged_mha(*ver)
        torch.cuda.synchronize()
        assert torch.equal(out_dec[0, 0], out_ver[0, j]), (p, j)


@gpu
def test_decode_row_and_verify_column_are_bitwise_equal_at_rep_71(cuda):
    """The same row invariance at Falcon-7B's heads (71 query heads of 64
    on one kv head): a decode row and a verify column sit at different rows
    of different 64-row tiles of the item, and read the same output."""
    S, MB = 8, 32
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert pa.split_count(S, 8, 71, 1, 64, MB, sms) == 1
    for p, j, dec, ver in verify_column_cases(cuda, S, MB, seed=71, H=71, KV=1, Dh=64):
        out_dec, out_ver = paged_mha(*dec), paged_mha(*ver)
        torch.cuda.synchronize()
        assert torch.equal(out_dec[0, 0], out_ver[0, j]), (p, j)


def test_paged_split_count_follows_the_shapes():
    """Splits only for a decode round's one-row-tile items that would not
    fill 4 x 2 x SMs blocks; at most MAX_SPLITS, each of two key tiles."""
    assert pa.split_count(32, 1, 32, 32, 64, 63, 132) == 2        # decode_7b
    assert pa.split_count(8, 8, 32, 32, 64, 25, 132) == 5         # decode_serve_7b
    assert pa.split_count(8, 8, 32, 8, 64, 25, 132) == 12         # Mixtral's round
    assert pa.split_count(4, 256, 32, 32, 64, 33, 132) == 1       # a prefill chunk
    assert pa.split_count(8, 8, 32, 32, 64, 1, 132) == 1          # one key tile
    assert pa.split_count(1, 1, 1, 1, 64, 4096, 132) == pa.MAX_SPLITS
    assert pa.split_count(600, 1, 32, 32, 64, 63, 132) == 1


@gpu
def test_kernel_raises_instead_of_falling_back(cuda):
    args, kw = make_case(cuda, Dh=40)
    before = paged_mha.launches
    with pytest.raises(ValueError, match="cannot take"):
        paged_mha(*args, **kw)
    q, k, v, bt, seen, ql = make_case(cuda)[0]
    with pytest.raises(TypeError, match="int32"):
        paged_mha(q, k, v, bt.long(), seen, ql)
    assert paged_mha.launches == before


# ---------------------------------------------------------------------------
# flash attention: forward, dq, dk/dv
# ---------------------------------------------------------------------------
#
# Tolerance, per element: |kernel - plain| <= RTOL * (|plain| + rms(plain))
# (the "flash form"). RTOL * |plain| is the one rounding of the output to its
# dtype; the rms term covers elements near 0; fp32 sums of thousands of terms
# in another order stay well inside 2^-16 of the scale. The bf16/fp16
# forward's out and dq add ``flip_slack`` (tests/flash_rounding.py): their
# tensor-core kernels sum q.k in another order than the plain fp32 GEMM, so
# a p or ds that lies within the two sums' error bound of a rounding
# boundary may round the other way, and each such one may move the output by
# one spacing times its |v| / l (|k|); every other p and ds must round as the
# plain version does. fp32, lse and dk/dv keep the flash form alone: the
# dk/dv tensor-core kernel splits p and ds into a 16-bit hi and lo part and
# multiplies both, so neither is rounded once.
# ``test_flash_bound_rejects_causal_fault`` shows that a key seen one position
# too early fails the bound; the rounding probes below show that p or ds
# rounded anywhere else than in the plain version fails the flash form.


def flash_ratio(out, ref, slack=None):
    """Largest |out - ref| over the flash form's bound, plus ``slack`` where
    given: at most 1 passes."""
    ref32 = ref.float()
    rtol = RTOL[ref.dtype]
    bound = rtol * (ref32.abs() + ref32.pow(2).mean().sqrt())
    if slack is not None:
        bound = bound + slack
    return ((out.float() - ref32).abs() / bound).max().item()


def flash_case(dev, B=2, Tq=128, Tk=None, H=4, KV=4, Dh=64, dtype=torch.bfloat16,
               bias=False, segments=False, fused=False, offset=False, seed=0):
    """q, k, v, dO from a seed; ``fused``: q/k/v are strided views of one
    [B, T, 3, H, Dh] projection; ``offset``: views that start one element
    into their storage (a base off 16 bytes)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    Tk = Tq if Tk is None else Tk
    r = lambda *s: torch.randn(*s, generator=g, device=dev).to(dtype)
    if fused:
        q, k, v = r(B, Tq, 3, H, Dh).unbind(2)
    elif offset:
        q, k, v = (r(B * T * h * Dh + 1)[1:].view(B, T, h, Dh)
                   for T, h in ((Tq, H), (Tk, KV), (Tk, KV)))
    else:
        q, k, v = r(B, Tq, H, Dh), r(B, Tk, KV, Dh), r(B, Tk, KV, Dh)
    dout = r(B, Tq, H, Dh)
    kw = {}
    if bias:
        kw["bias"] = torch.randn(1, H, Tq, Tk, generator=g, device=dev)
    if segments:
        ids = torch.sort(torch.randint(0, 3, (B, Tq), generator=g, device=dev),
                         dim=1).values.int()
        kw["segment_ids"] = (ids, ids)
    return (q, k, v, dout), kw


def flash_all(q, k, v, dout, fwd, dq, dkv, lse=None, delta=None, **kw):
    """(out, lse, dq, dk, dv) through the given three functions. The
    backward ones take ``lse`` and ``delta`` when given, so that two sets of
    functions can be compared on the same inputs."""
    out, lse_out = fwd(q, k, v, **kw)
    if lse is None:
        lse = lse_out
        delta = (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    return (out, lse_out, dq(q, k, v, dout, lse, delta, **kw),
            *dkv(q, k, v, dout, lse, delta, **kw))


def test_flash_bound_rejects_causal_fault():
    """The bound passes outputs moved by one unit in their last place and
    rejects a forward in which every query sees the next key too, and, with
    the tensor-core kernels' slack, such a forward and dq."""
    from deepspeed_tpu_torch.ops import flash_attention as fa
    for dtype in (torch.bfloat16, torch.float32):
        (q, k, v, dout), _ = flash_case(torch.device("cpu"), B=1, dtype=dtype)
        ref, lse = fa.flash_mha_fwd_reference(q, k, v)
        x = ref.float()
        ulp = torch.finfo(dtype).eps * torch.exp2(torch.floor(torch.log2(x.abs())))
        assert flash_ratio((x + ulp).to(dtype), ref) <= 1
        i = torch.arange(q.shape[1])
        one_ahead = torch.where(i[None, :] <= i[:, None] + 1, 0.0, fa.NEG_INF)
        fault = dict(bias=one_ahead[None, None], causal=False)
        off_by_one, _ = fa.flash_mha_fwd_reference(q, k, v, **fault)
        assert flash_ratio(off_by_one, ref) > 10
        if dtype != torch.float32:
            delta = (dout.float() * ref.float()).sum(-1).transpose(1, 2).contiguous()
            slack_out, slack_dq = flip_slack(q, k, v, dout, lse, delta)
            assert flash_ratio(off_by_one, ref, slack_out) > 10
            dq = fa.flash_mha_bwd_dq_reference(q, k, v, dout, lse, delta)
            dq_off = fa.flash_mha_bwd_dq_reference(q, k, v, dout, lse, delta, **fault)
            assert flash_ratio(dq_off, dq, slack_dq) > 10


def reordered_logits(plain_logits):
    """A stand-in for the plain versions' ``_masked_logits`` that sums q.k
    over 16-column chunks, as tensor cores do: the same logits in another
    summation order."""
    from deepspeed_tpu_torch.ops import flash_attention as fa

    def logits(q, k, b, bias, causal, scale, window, segment_ids):
        plain = plain_logits(q, k, b, bias, causal, scale, window, segment_ids)
        kf = k[b].float().repeat_interleave(q.shape[2] // k.shape[2], dim=1)
        s = sum(torch.einsum("qhd,khd->hqk", q[b, ..., c:c + 16].float(),
                             kf[..., c:c + 16])
                for c in range(0, q.shape[-1], 16)) * scale
        if bias is not None:
            s = s + bias[b if bias.shape[0] > 1 else 0].float()
        return torch.where(plain > fa.NEG_INF / 2, s, plain)
    return logits


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("name", ["causal", "gqa", "window", "bias", "dh256"])
def test_flip_slack_admits_reordered_logits(name, dtype):
    """The plain forward and dq computed from logits summed in another order
    round some p and ds the other way; the bound with ``flip_slack`` admits
    them."""
    from deepspeed_tpu_torch.ops import flash_attention as fa
    spec = dict(FLASH_CASES[name])
    window = spec.pop("window", None)
    causal = spec.pop("causal", True)
    args, kw = flash_case(torch.device("cpu"), B=1, dtype=dtype, **spec)
    kw.update(window=window, causal=causal)
    q, k, v, dout = args
    out, lse = fa.flash_mha_fwd_reference(q, k, v, **kw)
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    dq = fa.flash_mha_bwd_dq_reference(*args, lse, delta, **kw)
    slack_out, slack_dq = flip_slack(*args, lse, delta, **kw)
    with mock.patch.object(fa, "_masked_logits", reordered_logits(fa._masked_logits)):
        out_r = fa.flash_mha_fwd_reference(q, k, v, **kw)[0]
        dq_r = fa.flash_mha_bwd_dq_reference(*args, lse, delta, **kw)
    assert flash_ratio(out_r, out, slack_out) <= 1
    assert flash_ratio(dq_r, dq, slack_dq) <= 1


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("dh", [64, 128, 256])
def test_rounding_probes_reject_rounding_point_faults(dh, dtype):
    """On the probes the plain versions' outputs cancel to within a
    thousandth of the bound, in another summation order too, and p or ds
    rounded anywhere else (not at all, or against the other tile width's
    maxima) fails the flash form tenfold."""
    from deepspeed_tpu_torch.ops import flash_attention as fa
    cpu = torch.device("cpu")
    (q, k, v), kw = fwd_probe(dtype, dh, cpu)
    out = fa.flash_mha_fwd_reference(q, k, v, **kw)[0]
    cancels = lambda x, cols: (x[..., cols].float().abs().max()
                               < 1e-3 * RTOL[dtype] * x.float().pow(2).mean().sqrt())
    assert cancels(out, torch.arange(dh) % 8 != 0)
    with mock.patch.object(fa, "_masked_logits", reordered_logits(fa._masked_logits)):
        assert flash_ratio(fa.flash_mha_fwd_reference(q, k, v, **kw)[0], out) <= 1
    for fault, bad in fwd_rounding_faults(q, k, v, **kw).items():
        assert flash_ratio(bad, out) > 10, fault
    args, kw = dq_probe(dtype, dh, cpu)
    dq = fa.flash_mha_bwd_dq_reference(*args, **kw)
    assert cancels(dq, 1)
    for fault, bad in dq_rounding_faults(*args, **kw).items():
        assert flash_ratio(bad, dq) > 10, fault


FLASH_CASES = {
    "causal": dict(),
    "gqa": dict(H=8, KV=2),
    "window": dict(window=40),
    "segments": dict(segments=True),
    "bias": dict(bias=True, causal=False),
    "rect": dict(Tq=64, Tk=192),
    "ragged": dict(Tq=100),
    "dh256": dict(Dh=256, H=2, KV=1),
    "dh40": dict(Dh=40),
    # the tensor-core kernels' edges: 128-row query tiles, 64/128-key tiles,
    # staged head widths, TMA reading strided views in place
    "tq_off_tile": dict(Tq=300),
    "tk_under_one_tile": dict(Tq=24, Tk=40),
    "dh96": dict(Dh=96),
    "gqa_rep8": dict(H=8, KV=1),
    "window_under_tile": dict(Tq=300, window=24),
    "fused_qkv_views": dict(fused=True),
    "base_off_16_bytes": dict(offset=True),
    "dh36_padded_copy": dict(Dh=36),
    # GPT-2 large's training shape (chip_smoke.py phase 28): 20 heads of 64
    "gpt2_large": dict(B=8, Tq=1024, H=20, KV=20, Dh=64),
}


@gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("name", list(FLASH_CASES))
def test_flash_kernels_match_plain(cuda, name, dtype):
    from deepspeed_tpu_torch.ops import flash_attention as fa
    spec = dict(FLASH_CASES[name])
    window = spec.pop("window", None)
    causal = spec.pop("causal", True)
    args, kw = flash_case(cuda, dtype=dtype, **spec)
    kw.update(window=window, causal=causal)
    want = flash_all(*args, fa.flash_mha_fwd_reference,
                     fa.flash_mha_bwd_dq_reference,
                     fa.flash_mha_bwd_dkv_reference, **kw)
    delta = (args[3].float() * want[0].float()).sum(-1).transpose(1, 2).contiguous()
    slack = (None, None)
    if dtype != torch.float32:
        slack = flip_slack(*args, want[1], delta, **kw)
    before = (fa.flash_mha_fwd.launches, fa.flash_mha_bwd_dq.launches,
              fa.flash_mha_bwd_dkv.launches)
    tally = fa.kernel_launches()
    got = flash_all(*args, fa.flash_mha_fwd, fa.flash_mha_bwd_dq,
                    fa.flash_mha_bwd_dkv, lse=want[1], delta=delta, **kw)
    assert (fa.flash_mha_fwd.launches, fa.flash_mha_bwd_dq.launches,
            fa.flash_mha_bwd_dkv.launches) == tuple(n + 1 for n in before)
    routed = {f"{w}_{fa.kernel_route(w, dtype, args[0].shape[-1])}" for w in ("fwd", "dq", "dkv")}
    launched = {n: c - tally[n] for n, c in fa.kernel_launches().items()}
    assert launched == {n: int(n in routed) for n in fa.KERNELS}, launched
    torch.cuda.synchronize()
    for label, a, b, m in zip(("out", "lse", "dq", "dk", "dv"), got, want,
                              (slack[0], None, slack[1], None, None)):
        assert torch.isfinite(a).all(), label
        assert flash_ratio(a, b, m) <= 1, (label, flash_ratio(a, b, m))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("dh", [64, 96, 128, 256])
def test_dkv_probe_rejects_rounding_once(dh, dtype):
    """On ``dkv_probe`` the plain dk/dv gives the exact values, and so do
    the kernel's split products (``dkv_split_product``, 0 of the bound);
    p or ds rounded once to the dtype cancels the probe's outputs and fails
    the flash form more than tenfold (64x in bf16, 512x in fp16 by
    construction)."""
    from deepspeed_tpu_torch.ops import flash_attention as fa
    args, kw = dkv_probe(dtype, dh, torch.device("cpu"))
    ref = fa.flash_mha_bwd_dkv_reference(*args, **kw)
    for got, exact in zip(ref, dkv_probe_value(dh)):
        assert torch.equal(got.float(), exact)
    assert max(flash_ratio(a, r) for a, r in zip(dkv_split_product(*args, **kw), ref)) == 0
    for fault, bad in dkv_rounding_faults(*args, **kw).items():
        assert max(flash_ratio(a, r) for a, r in zip(bad, ref)) > 10, fault


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("name", ["causal", "gqa", "window", "bias", "dh96", "ragged"])
def test_dkv_split_product_holds_flash_form(name, dtype):
    """The dk/dv kernel's arithmetic, p and ds split into hi and lo parts
    in the input dtype (``dkv_split_product``), holds the plain dk/dv's
    flash form with no slack on random data: the split's residual (about
    2^-16 of p in bf16, 2^-22 in fp16 or an absolute 2^-25 where lo is
    subnormal) is far inside one rounding of the output."""
    from deepspeed_tpu_torch.ops import flash_attention as fa
    spec = dict(FLASH_CASES[name])
    window = spec.pop("window", None)
    causal = spec.pop("causal", True)
    args, kw = flash_case(torch.device("cpu"), B=1, dtype=dtype, **spec)
    kw.update(window=window, causal=causal)
    q, k, v, dout = args
    out, lse = fa.flash_mha_fwd_reference(q, k, v, **kw)
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    ref = fa.flash_mha_bwd_dkv_reference(*args, lse, delta, **kw)
    got = dkv_split_product(*args, lse, delta, **kw)
    assert max(flash_ratio(a, r) for a, r in zip(got, ref)) <= 1


# dO ~ N(0, 1) times this is the size of an unscaled gradient: ds about
# 1e-6, below fp16's smallest normal (6.1e-5), while dK stays normal
SMALL_GRAD = 1e-3


def small_gradient_case(dev, name, dtype, grad=SMALL_GRAD, B=1, Tq=512, Dh=128, H=2):
    """(q, k, v, dO, lse, delta), kwargs of FLASH_CASES[name] at ``Tq``
    queries of head width ``Dh``, dO scaled by ``grad``."""
    from deepspeed_tpu_torch.ops import flash_attention as fa
    spec = dict(FLASH_CASES[name])
    window = spec.pop("window", None)
    causal = spec.pop("causal", True)
    spec.setdefault("H", H)
    spec.setdefault("KV", spec["H"])
    (q, k, v, dout), kw = flash_case(dev, B=B, Tq=Tq, Dh=Dh, dtype=dtype, **spec)
    kw.update(window=window, causal=causal)
    dout = (dout.float() * grad).to(dtype)
    out, lse = fa.flash_mha_fwd_reference(q, k, v, **kw)
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    return (q, k, v, dout, lse, delta), kw


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("name", ["causal", "gqa"])
def test_dkv_split_product_holds_flash_form_at_small_gradients(name, dtype):
    """With dO the size of an unscaled gradient the kernel's split arithmetic
    holds the flash form with no slack. In fp16 that needs its ds scale
    (2^``DS_EXP0``): split as is, ds_hi is subnormal, ds_lo carries
    nothing, and dK fails the bound."""
    from deepspeed_tpu_torch.ops import flash_attention as fa
    args, kw = small_gradient_case(torch.device("cpu"), name, dtype)
    ref = fa.flash_mha_bwd_dkv_reference(*args, **kw)
    assert ref[0].float().abs().max() > torch.finfo(torch.float16).tiny
    assert max(flash_ratio(a, r) for a, r in zip(dkv_split_product(*args, **kw), ref)) <= 1
    if dtype == torch.float16:
        dk, _ = dkv_split_product(*args, ds_scale=1.0, **kw)
        assert flash_ratio(dk, ref[0]) > 1


@gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("name", ["causal", "gqa"])
def test_dkv_kernel_holds_flash_form_at_small_gradients(cuda, name, dtype):
    """The dk/dv kernel with dO the size of an unscaled gradient launches
    its routed kernel and holds the flash form with no slack."""
    from deepspeed_tpu_torch.ops import flash_attention as fa
    args, kw = small_gradient_case(cuda, name, dtype)
    tally = fa.kernel_launches()
    got = fa.flash_mha_bwd_dkv(*args, **kw)
    launched = {n: c - tally[n] for n, c in fa.kernel_launches().items() if c > tally[n]}
    assert launched == {f"dkv_{fa.kernel_route('dkv', dtype, 128)}": 1}
    ref = fa.flash_mha_bwd_dkv_reference(*args, **kw)
    torch.cuda.synchronize()
    for a, r in zip(got, ref):
        assert torch.isfinite(a).all()
        assert flash_ratio(a, r) <= 1


# dO ~ N(0, 1) times this is the size of a gradient under fp16's default
# loss scale (2^16 times about 4e-3): max |ds| between 64 and 1000 (about
# 130 at 2 heads of 512 queries, 230 at 32 heads of 1024), where a fixed
# 2^10 split scale sends ds_hi, and with it dK, to inf while the plain
# fp32-ds dK stays finite
LARGE_DS_GRAD = 2.0 ** 8


def assert_large_ds(args, kw):
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from flash_rounding import max_abs_ds
    assert 64 < max_abs_ds(*args, **kw) < 1000
    ref = fa.flash_mha_bwd_dkv_reference(*args, **kw)
    assert all(torch.isfinite(r).all() for r in ref)
    return ref


@pytest.mark.parametrize("name", ["causal", "gqa"])
def test_dkv_split_product_holds_flash_form_at_large_ds(name):
    """fp16 dk/dv with max |ds| over 64: split times the fixed 2^10, ds_hi
    overflows and dK reads inf; the kernel's rule (an exponent per key row,
    lowered where a query tile's |ds| needs it) holds the flash form with no
    slack, and so it still does at small gradients (the test above)."""
    args, kw = small_gradient_case(torch.device("cpu"), name, torch.float16,
                                   grad=LARGE_DS_GRAD)
    ref = assert_large_ds(args, kw)
    dk, dv = dkv_split_product(*args, **kw)
    assert flash_ratio(dk, ref[0]) <= 1 and flash_ratio(dv, ref[1]) <= 1
    fixed_dk, _ = dkv_split_product(*args, ds_scale=2.0 ** 10, **kw)
    assert not torch.isfinite(fixed_dk).all()


@gpu
@pytest.mark.parametrize("dh", [64, 128])
def test_dkv_kernel_holds_flash_form_at_large_ds(cuda, dh):
    """fp16 dk/dv at B 2, T 1024, 32 heads, dO scaled so that max |ds| lies
    between 64 and 1000: the routed kernel gives finite dK and dV within the
    flash form with no slack (a fixed 2^10 split scale gave inf)."""
    from deepspeed_tpu_torch.ops import flash_attention as fa
    args, kw = small_gradient_case(cuda, "causal", torch.float16, grad=LARGE_DS_GRAD,
                                   B=2, Tq=1024, Dh=dh, H=32)
    ref = assert_large_ds(args, kw)
    tally = fa.kernel_launches()
    got = fa.flash_mha_bwd_dkv(*args, **kw)
    launched = {n: c - tally[n] for n, c in fa.kernel_launches().items() if c > tally[n]}
    assert launched == {f"dkv_{fa.kernel_route('dkv', torch.float16, dh)}": 1}
    torch.cuda.synchronize()
    for a, r in zip(got, ref):
        assert torch.isfinite(a).all()
        assert flash_ratio(a, r) <= 1


@gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("dh", [64, 128, 256])
def test_flash_kernels_round_where_plain_does(cuda, dh, dtype):
    """On the rounding probes the forward and dq kernels hold the flash form
    with no slack, which every rounding-point fault fails; on ``dkv_probe``
    the dk/dv kernel reads under 0.01 of the bound (its sums are exact),
    where p or ds rounded once reads over 10."""
    from deepspeed_tpu_torch.ops import flash_attention as fa
    (q, k, v), kw = fwd_probe(dtype, dh, cuda)
    out = fa.flash_mha_fwd(q, k, v, **kw)[0]
    ref = fa.flash_mha_fwd_reference(q, k, v, **kw)[0]
    assert flash_ratio(out, ref) <= 1
    assert all(flash_ratio(bad, ref) > 10 for bad in fwd_rounding_faults(q, k, v, **kw).values())
    args, kw = dq_probe(dtype, dh, cuda)
    ref = fa.flash_mha_bwd_dq_reference(*args, **kw)
    assert flash_ratio(fa.flash_mha_bwd_dq(*args, **kw), ref) <= 1
    assert all(flash_ratio(bad, ref) > 10 for bad in dq_rounding_faults(*args, **kw).values())
    args, kw = dkv_probe(dtype, dh, cuda)
    ref = fa.flash_mha_bwd_dkv_reference(*args, **kw)
    ratio = lambda got: max(flash_ratio(a, r) for a, r in zip(got, ref))
    assert ratio(fa.flash_mha_bwd_dkv(*args, **kw)) <= 0.01
    assert all(ratio(bad) > 10 for bad in dkv_rounding_faults(*args, **kw).values())


def source_kernels(source):
    """The kernel names of a source's launch tally, from its ``enum Kernel``
    (kDkvWgmma -> dkv_wgmma), in order."""
    import re
    from pathlib import Path
    text = (Path(__file__).resolve().parents[1] / "deepspeed_tpu_torch" / "csrc"
            / source).read_text()
    body = re.search(r"enum Kernel \{([^}]*)\}", text).group(1)
    names = [n.strip() for n in body.split(",") if n.strip() not in ("", "kNumKernels")]
    return tuple(re.sub(r"(?<!^)(?=[A-Z])", "_", n[1:]).lower() for n in names)


class StandInLibrary:
    """A library stand-in for the route and tally readers: records the
    route query and answers with ``route``; launches of kernel i are 10 i."""

    def __init__(self, route):
        self.route, self.asked = route, None

    def _route(self, *args):
        self.asked = args
        return self.route

    ds_flash_route = ds_grouped_route = ds_sparse_route = ds_qmm_route = ds_paged_route = _route
    ds_quant_route = _route

    def ds_flash_kernel_launches(self, i):
        return 10 * i

    ds_grouped_kernel_launches = ds_sparse_kernel_launches = ds_flash_kernel_launches
    ds_qmm_kernel_launches = ds_paged_kernel_launches = ds_flash_kernel_launches
    ds_quant_kernel_launches = ds_flash_kernel_launches


@pytest.mark.parametrize("module,source", [("flash_attention", "flash_attention.cu"),
                                           ("grouped_gemm", "grouped_gemm.cu"),
                                           ("block_sparse_attention",
                                            "block_sparse_attention.cu"),
                                           ("quantized_matmul", "quantized_matmul.cu"),
                                           ("paged_attention", "paged_attention.cu"),
                                           ("quant_collective", "quant_collective.cu")])
def test_kernel_tally_names_follow_the_source(module, source):
    """``KERNELS``, the names ``kernel_launches`` gives the library's tally,
    is the source's ``enum Kernel`` in order; the reader maps count i to
    name i."""
    import importlib
    mod = importlib.import_module(f"deepspeed_tpu_torch.ops.{module}")
    assert mod.KERNELS == source_kernels(source)
    with mock.patch.object(mod, "_library", lambda: StandInLibrary(0)):
        assert mod.kernel_launches() == {n: 10 * i for i, n in enumerate(mod.KERNELS)}


def test_flash_route_reader_asks_by_dtype_and_head_width():
    """``kernel_route`` hands the source (which, dtype code, head width) and
    names its answer; a refusal (-1) raises."""
    from deepspeed_tpu_torch.ops import flash_attention as fa
    for answer, name in ((1, "wgmma"), (0, "simt")):
        lib = StandInLibrary(answer)
        with mock.patch.object(fa, "_library", lambda: lib):
            assert fa.kernel_route("dkv", torch.float16, 96) == name
        assert lib.asked == (2, 1, 96)
    with mock.patch.object(fa, "_library", lambda: StandInLibrary(-1)):
        with pytest.raises(ValueError, match="head width 300"):
            fa.kernel_route("fwd", torch.bfloat16, 300)


def test_grouped_route_reader_asks_by_dtype_rows_and_experts():
    """``kernel_route`` hands the source (which, dtype code), rows and
    experts no longer choosing the kernel, and returns the kernel it names
    by index; a refusal (-1) raises."""
    from deepspeed_tpu_torch.ops import grouped_gemm as gg
    lib = StandInLibrary(gg.KERNELS.index("dx_wgmma"))
    with mock.patch.object(gg, "_library", lambda: lib):
        assert gg.kernel_route("dx", torch.bfloat16) == "dx_wgmma"
    assert lib.asked == (1, 2)
    with mock.patch.object(gg, "_library", lambda: StandInLibrary(-1)):
        with pytest.raises(ValueError, match="dx"):
            gg.kernel_route("dx", torch.float16)


def test_sparse_route_reader_asks_by_dtype_block_and_head_width():
    """``kernel_route`` hands the source (dtype code, block, head width) and
    returns the kernel it names by index; a refusal (-1) raises."""
    from deepspeed_tpu_torch.ops import block_sparse_attention as bsa
    for name in bsa.KERNELS:
        lib = StandInLibrary(bsa.KERNELS.index(name))
        with mock.patch.object(bsa, "_library", lambda: lib):
            assert bsa.kernel_route(torch.float16, 64, 96) == name
        assert lib.asked == (1, 64, 96)
    with mock.patch.object(bsa, "_library", lambda: StandInLibrary(-1)):
        with pytest.raises(ValueError, match="block 256"):
            bsa.kernel_route(torch.bfloat16, 256, 128)


def test_qmm_and_paged_route_readers_ask_the_source():
    """``kernel_route`` of rows 7 and 1 hands the source its arguments
    (rows; dtype code, int8 pools, head width, block size) and names the
    kernel by index; a refusal (-1) raises."""
    from deepspeed_tpu_torch.ops import quantized_matmul as qm
    for name in qm.KERNELS:
        lib = StandInLibrary(qm.KERNELS.index(name))
        with mock.patch.object(qm, "_library", lambda: lib):
            assert qm.kernel_route(13) == name
        assert lib.asked == (13,)
    for name in pa.KERNELS:
        lib = StandInLibrary(pa.KERNELS.index(name))
        with mock.patch.object(pa, "_library", lambda: lib):
            assert pa.kernel_route(torch.float16, True, 128, 64) == name
        assert lib.asked == (1, 1, 128, 64)
    with mock.patch.object(qm, "_library", lambda: StandInLibrary(-1)):
        with pytest.raises(ValueError, match="M=0"):
            qm.kernel_route(0)
    with mock.patch.object(pa, "_library", lambda: StandInLibrary(-1)):
        with pytest.raises(ValueError, match="head width 40"):
            pa.kernel_route(torch.bfloat16, False, 40, 64)


def test_quant_route_reader_asks_the_source():
    """``kernel_route`` of rows 5 and 6 hands the source (op code, length,
    group size, bits, dtype code, peers, aligned) and names the kernel by
    index; a refusal (-1) raises."""
    from deepspeed_tpu_torch.ops import quant_collective as qc
    for name in qc.KERNELS:
        lib = StandInLibrary(qc.KERNELS.index(name))
        with mock.patch.object(qc, "_library", lambda: lib):
            assert qc.kernel_route("quantize", 11_272_192, 2048, 4, torch.bfloat16) == name
        assert lib.asked == (0, 11_272_192, 2048, 4, 2, 1, 1)
    lib = StandInLibrary(qc.KERNELS.index("dequant_reduce_block"))
    with mock.patch.object(qc, "_library", lambda: lib):
        assert qc.kernel_route("dequantize_reduce", 1001, 250, 8, peers=3,
                               aligned=False) == "dequant_reduce_block"
    assert lib.asked == (1, 1001, 250, 8, 0, 3, 0)
    with mock.patch.object(qc, "_library", lambda: StandInLibrary(-1)):
        with pytest.raises(ValueError, match="group 7"):
            qc.kernel_route("quantize", 100, 7, 4)


def test_plan_constants_match_the_source():
    """The Python side's copies of the constants its plans mirror are the
    sources': row 7's decode row limit, column tile and stage, and the
    paged kernel's key tile."""
    import re
    from pathlib import Path
    from deepspeed_tpu_torch.ops import quantized_matmul as qm
    csrc = Path(__file__).resolve().parents[1] / "deepspeed_tpu_torch" / "csrc"
    qmm = (csrc / "quantized_matmul.cu").read_text()
    paged = (csrc / "paged_attention.cu").read_text()
    assert int(re.search(r"kDecodeMaxRows = (\d+);", qmm).group(1)) == qm.DECODE_MAX_ROWS
    assert int(re.search(r"constexpr int kBN = (\d+);", qmm).group(1)) == qm.BN
    assert int(re.search(r"constexpr int kBK = (\d+);", qmm).group(1)) == qm.BK
    assert int(re.search(r"constexpr int kTile = (\d+);", paged).group(1)) == pa.KEY_TILE


@gpu
def test_paged_main_path_and_probe_shapes_route_to_tensor_cores(cuda):
    """The source routes the serving main path's shape (bf16 q and pools,
    head width 128, pages of 64) and the rounding probe's shapes (bf16 and
    fp16, widths 64 and 128, pages of 16, 32 and 64) to the wgmma kernel."""
    assert pa.kernel_route(torch.bfloat16, False, 128, 64) == "wgmma"
    for dtype in (torch.bfloat16, torch.float16):
        for dh in (64, 128):
            for bs in (16, 32, 64):
                assert pa.kernel_route(dtype, False, dh, bs) == "wgmma", (dtype, dh, bs)


@gpu
def test_flash_kernel_key_tiles_match_plain_table(cuda):
    """The forward kernel rounds p against the running maximum of its key
    tiles; the plain version must take the same tiles (``FWD_BLOCK_K``).
    The source routes bf16/fp16 forward, dq and dk/dv to the tensor-core
    kernels, dk/dv at head width 256 to its SIMT kernel."""
    from deepspeed_tpu_torch.ops import flash_attention as fa
    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        for dh in (1, 40, 64, 96, 128, 200, 256):
            assert fa.kernel_block_k(dtype, dh) == fa.fwd_block_k(dtype, dh), (dtype, dh)
            route = "simt" if dtype == torch.float32 else "wgmma"
            dkv = route if dh <= 128 else "simt"
            assert [fa.kernel_route(w, dtype, dh) for w in ("fwd", "dq", "dkv")] == \
                [route, route, dkv], (dtype, dh)


@gpu
def test_flash_autograd_on_cuda(cuda):
    """mha's autograd Function launches forward, dq and dk/dv once each and
    gives the gradients of the plain versions."""
    from deepspeed_tpu_torch.ops import flash_attention as fa
    (q, k, v, dout), _ = flash_case(cuda, H=8, KV=2, dtype=torch.float32)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    fa.reset_launch_counts()
    out = fa.mha(*leaves, causal=True)
    out.backward(dout)
    assert (fa.flash_mha_fwd.launches, fa.flash_mha_bwd_dq.launches,
            fa.flash_mha_bwd_dkv.launches) == (1, 1, 1)
    want = flash_all(q, k, v, dout, fa.flash_mha_fwd_reference,
                     fa.flash_mha_bwd_dq_reference,
                     fa.flash_mha_bwd_dkv_reference)
    for a, b in zip((out, leaves[0].grad, leaves[1].grad, leaves[2].grad),
                    (want[0], *want[2:])):
        assert flash_ratio(a.detach(), b) <= 1


@gpu
def test_flash_raises_instead_of_falling_back(cuda):
    from deepspeed_tpu_torch.ops import flash_attention as fa
    (q, k, v, _), _ = flash_case(cuda, Dh=64)
    before = fa.flash_mha_fwd.launches
    with pytest.raises(ValueError, match="head dim"):
        fa.mha(torch.cat([q] * 5, -1), torch.cat([k] * 5, -1),
               torch.cat([v] * 5, -1))
    with pytest.raises(TypeError):
        fa.flash_mha_fwd(q, k.float(), v)
    assert fa.flash_mha_fwd.launches == before


@gpu
def test_training_on_cuda_runs_the_flash_kernels(cuda):
    """A tiny Llama trained through initialize on the card: every layer's
    attention launches the forward kernel twice per micro-step (activation
    checkpointing recomputes it) and dq and dk/dv once; the loss falls."""
    import numpy as np
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from deepspeed_tpu_torch.ops import flash_attention as fa
    cfg = LlamaConfig.tiny(dtype=torch.float32)
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=LlamaForCausalLM.from_seed(cfg, seed=0, device=cuda),
        config={"train_batch_size": 4, "gradient_accumulation_steps": 2,
                "bf16": {"enabled": True},
                "optimizer": {"type": "AdamW", "params": {"lr": 1e-2}}})
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 100))
    batch = {"input_ids": ids, "labels": ids}
    fa.reset_launch_counts()
    tally = fa.kernel_launches()
    losses = [float(engine.train_batch(iter([batch] * 2))) for _ in range(3)]
    L, micro = cfg.num_hidden_layers, 6
    assert (fa.flash_mha_fwd.launches, fa.flash_mha_bwd_dq.launches,
            fa.flash_mha_bwd_dkv.launches) == (2 * L * micro, L * micro, L * micro)
    launched = {n: c - tally[n] for n, c in fa.kernel_launches().items() if c > tally[n]}
    assert launched == {"fwd_wgmma": 2 * L * micro, "dq_wgmma": L * micro,
                        "dkv_wgmma": L * micro}
    assert losses[-1] < losses[0]


@gpu
def test_engine_on_cuda_runs_the_kernel(cuda):
    import numpy as np
    from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2
    from deepspeed_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    model = LlamaForCausalLM.from_seed(LlamaConfig.tiny(dtype=torch.float32),
                                       seed=0, device=cuda)
    cfg = {"state_manager": {"max_ragged_sequence_count": 4,
                             "max_ragged_batch_size": 32, "max_context": 128,
                             "num_kv_blocks": 32},
           "kv_cache": {"block_size": 8, "cache_dtype": "fp32"}}
    kernel = InferenceEngineV2(model, cfg)
    dense = InferenceEngineV2(model, dict(cfg, modules={"attention": "dense"}))
    ids = np.arange(19, dtype=np.int32)
    before = paged_mha.launches
    a = kernel.put([1], [ids])
    assert paged_mha.launches == before + model.config.num_hidden_layers
    b = dense.put([1], [ids])
    assert paged_mha.launches == before + model.config.num_hidden_layers
    np.testing.assert_allclose(a, b, atol=1e-4, rtol=0)


# ---------------------------------------------------------------------------
# grouped GEMM (MoE expert FFN)
# ---------------------------------------------------------------------------
#
# Tolerance: the flash form, |kernel - plain| <= RTOL * (|plain| + rms(plain)).
# Kernel and plain version multiply the same bf16/fp16 (exact in fp32) or
# fp32 values, sum in fp32 in another order and round once to the dtype:
# RTOL * |plain| is that rounding, the rms term the fp32 summation-order
# noise of elements near 0. ``test_gmm_bound_rejects_shifted_offset`` shows
# that one row computed with a neighbouring expert's weights fails it.

GMM_CASES = {
    # name: R, K, N, group_offsets (E = 4)
    "balanced": (200, 128, 256, [0, 50, 100, 150, 200]),
    "empty_groups": (130, 64, 128, [0, 0, 70, 70, 130]),
    "one_group_all_rows": (300, 128, 128, [0, 0, 300, 300, 300]),
    "r1": (1, 128, 64, [0, 0, 0, 1, 1]),
    "ragged_r_k_n": (77, 200, 72, [0, 13, 40, 41, 77]),
    "wide_n": (129, 64, 264, [0, 129, 129, 129, 129]),
    # several 64-row stages per expert, each expert ending off a multiple of
    # 64: dW's last stage of an expert holds the next expert's rows
    "boundaries_off_64": (700, 192, 512, [0, 65, 65, 383, 700]),
}


def gmm_kernel(which, dtype):
    """The kernel the source routes ``which`` in ``dtype`` to."""
    from deepspeed_tpu_torch.ops import grouped_gemm as gg
    return gg.kernel_route(which, dtype)


@gpu
def test_grouped_routes_put_16_bit_products_on_tensor_cores(cuda):
    """The source routes bf16/fp16 forward and bf16 dx and dW to the wgmma
    kernels, and fp32 to the SIMT kernels."""
    from deepspeed_tpu_torch.ops import grouped_gemm as gg
    routes = {(w, dt): gg.kernel_route(w, dt) for w in ("fwd", "dx", "dw")
              for dt in (torch.float32, torch.bfloat16)}
    assert routes == {("fwd", torch.float32): "fwd_simt", ("fwd", torch.bfloat16): "fwd_wgmma",
                      ("dx", torch.float32): "dx_simt", ("dx", torch.bfloat16): "dx_wgmma",
                      ("dw", torch.float32): "dw_simt", ("dw", torch.bfloat16): "dw_wgmma"}
    assert gg.kernel_route("fwd", torch.float16) == "fwd_wgmma"


@pytest.mark.parametrize("name,group", [
    ("void (anonymous namespace)::grouped_gemm_wgmma<__nv_bfloat16, false>(CUtensorMap_st, "
     "CUtensorMap_st, int const*, __nv_bfloat16*, int, int, int)", "grouped_gemm_fwd"),
    ("void (anonymous namespace)::grouped_gemm_wgmma<__nv_bfloat16, true>(CUtensorMap_st, "
     "CUtensorMap_st, int const*, __nv_bfloat16*, int, int, int)", "grouped_gemm_dx"),
    ("void (anonymous namespace)::grouped_tgmm_wgmma<__nv_bfloat16>(CUtensorMap_st, "
     "CUtensorMap_st, int const*, __nv_bfloat16*, int, int, int)", "grouped_gemm_dw"),
    ("void (anonymous namespace)::grouped_tgmm_fp32_kernel(float const*, float const*, "
     "int const*, float*, int, int)", "grouped_gemm_dw"),
    ("void (anonymous namespace)::grouped_gemm_fp32_kernel<true>(float const*, float const*, "
     "int const*, float*, int, int, int)", "grouped_gemm_dx"),
])
def test_training_profile_groups_each_grouped_kernel_apart(name, group):
    """``tools/profile_train.py`` puts each grouped kernel's device time in
    its own group, the dW kernels under ``grouped_gemm_dw``, by the names the
    profiler reports."""
    from deepspeed_tpu_torch.tools.profile_train import _group
    assert _group(name) == group


@pytest.mark.parametrize("name,group", [
    ("void (anonymous namespace)::quantize_warp<float, 4>(float const*, unsigned char*, "
     "float*, long long, int, int, long long)", "qgz_quantize"),
    ("void (anonymous namespace)::quantize_block<__nv_bfloat16, 8, 8>(__nv_bfloat16 const*, "
     "unsigned char*, float*, long long, int, int)", "qgz_quantize"),
    ("void (anonymous namespace)::quantize_kernel<float, 4, 4>(float const*, unsigned char*, "
     "float*, long long, int, int)", "qgz_quantize"),
    ("void (anonymous namespace)::dequant_reduce_stream<4, 4>(unsigned char const*, "
     "float const*, float*, long long, int, int, long long)", "qgz_dequant_reduce"),
    ("void (anonymous namespace)::dequant_reduce_block<8, 1>(unsigned char const*, "
     "float const*, float*, int, long long, int, int, long long, bool)",
     "qgz_dequant_reduce"),
    ("ncclDevKernel_SendRecv(ncclDevComm*, unsigned long, ncclWork*)", "nccl_collectives"),
    ("void (anonymous namespace)::quantized_matmul_decode<__nv_bfloat16, __nv_bfloat16, 1>("
     "CUtensorMap_st, CUtensorMap_st, float const*, __nv_bfloat16*, float*, int, int, int, "
     "int, int, int)", "elementwise_and_other"),
])
def test_training_profile_groups_the_qgz_kernels_apart(name, group):
    """``tools/profile_train.py`` puts rows 5 and 6 (both routes, and the
    kernel names before them) in groups of their own, and nothing else
    with "quantize" in its name."""
    from deepspeed_tpu_torch.tools.profile_train import _group
    assert _group(name) == group


def test_training_profile_refuses_qgz_without_zero_and_cards():
    """``--qgz`` needs a ZeRO stage and 2 or more cards; ``--ep`` needs
    Mixtral."""
    from deepspeed_tpu_torch.tools import profile_train
    for argv in (["--qgz", "--world", "4"], ["--zero", "3", "--qgz"],
                 ["--ep", "4"]):
        with pytest.raises(SystemExit):
            profile_train.main(argv)


@pytest.mark.parametrize("name", [
    "void (anonymous namespace)::paged_mha_wgmma<__nv_bfloat16, 128>((anonymous "
    "namespace)::PagedParams, CUtensorMap_st, CUtensorMap_st)",
    "void (anonymous namespace)::paged_mha_combine<__nv_bfloat16, 128>((anonymous "
    "namespace)::PagedParams)",
    "void (anonymous namespace)::paged_mha_kernel<float, signed char, 128>(float const*, ...)",
    "void (anonymous namespace)::quantized_matmul_decode<__nv_bfloat16, __nv_bfloat16, 1>("
    "CUtensorMap_st, CUtensorMap_st, float const*, __nv_bfloat16*, float*, int, int, int, "
    "int, int, int)",
    "void (anonymous namespace)::quantized_matmul_wgmma<__nv_bfloat16, __nv_bfloat16>(...)",
    "void (anonymous namespace)::quantized_matmul_split_reduce<__nv_bfloat16>(float const*, "
    "__nv_bfloat16*, long, int)",
])
def test_decode_profile_groups_rows_1_and_7(name):
    """``tools/profile_decode.py`` puts every kernel of rows 1 and 7, the
    passes that merge their key splits included, in the row's group."""
    from deepspeed_tpu_torch.tools.profile_decode import _group
    assert _group(name) == ("paged_attention" if "paged_mha" in name else "quantized_matmul")


def gmm_launched(gg, tally):
    """The grouped kernels launched since ``tally`` (``kernel_launches()``)."""
    return {n: c - tally[n] for n, c in gg.kernel_launches().items() if c > tally[n]}


def gmm_case(dev, R, K, N, offsets, dtype, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    E = len(offsets) - 1
    xs = torch.randn(R, K, generator=g, device=dev).to(dtype)
    w = (torch.randn(E, K, N, generator=g, device=dev) * K ** -0.5).to(dtype)
    return xs, w, torch.tensor(offsets, dtype=torch.int32, device=dev)


def shifted(offsets):
    """Group offsets with one boundary moved by a row: the last row of the
    first non-empty group that has a right neighbour joins that
    neighbour, or else the first row of the last group joins the one
    before."""
    offs = list(offsets)
    for i in range(1, len(offs) - 1):
        if offs[i] > offs[i - 1]:
            offs[i] -= 1
            return offs
    offs[-2] += 1
    return offs


@pytest.mark.parametrize("name", list(GMM_CASES))
def test_gmm_bound_rejects_shifted_offset(name):
    from deepspeed_tpu_torch.ops.grouped_gemm import grouped_matmul_reference
    R, K, N, offs = GMM_CASES[name]
    xs, w, offsets = gmm_case(torch.device("cpu"), R, K, N, offs, torch.bfloat16)
    ref = grouped_matmul_reference(xs, w, offsets)
    x = ref.float()
    ulp = torch.finfo(ref.dtype).eps * torch.exp2(torch.floor(torch.log2(x.abs())))
    assert flash_ratio((x + ulp).to(ref.dtype), ref) <= 1
    bad = torch.tensor(shifted(offs), dtype=torch.int32)
    assert flash_ratio(grouped_matmul_reference(xs, w, bad), ref) > 10


@gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("name", list(GMM_CASES))
def test_gmm_kernel_matches_plain(cuda, name, dtype):
    from deepspeed_tpu_torch.ops import grouped_gemm as gg
    from deepspeed_tpu_torch.ops.grouped_gemm import (grouped_matmul,
                                                      grouped_matmul_reference)
    R, K, N, offs = GMM_CASES[name]
    xs, w, offsets = gmm_case(cuda, R, K, N, offs, dtype, seed=R)
    before, tally = grouped_matmul.launches, gg.kernel_launches()
    out = grouped_matmul(xs, w, offsets)
    assert grouped_matmul.launches == before + 1
    assert gmm_launched(gg, tally) == {gmm_kernel("fwd", dtype): 1}
    ref = grouped_matmul_reference(xs, w, offsets)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    assert flash_ratio(out, ref) <= 1


# Mixtral-8x7B's expert products at tp 2: each rank holds F / 2 = 7168 of
# every expert's width. Rows: a decode round's 8 tokens (top-2 of 8) and a
# mixed round's 512, routed at random.
TP_GMM_CASES = {
    "decode_w13": (16, 4096, 7168), "decode_w2": (16, 7168, 4096),
    "mixed_w13": (1024, 4096, 7168), "mixed_w2": (1024, 7168, 4096),
}


def top2_offsets(R, E, seed):
    rng = np.random.default_rng(seed)
    rows = np.concatenate([rng.permutation(E)[:2] for _ in range(R // 2)])
    return np.concatenate([[0], np.cumsum(np.bincount(rows, minlength=E))]).tolist()


@gpu
@pytest.mark.parametrize("name", list(TP_GMM_CASES))
def test_gmm_kernel_at_mixtral_tp2_width(cuda, name):
    from deepspeed_tpu_torch.ops import grouped_gemm as gg
    from deepspeed_tpu_torch.ops.grouped_gemm import (grouped_matmul,
                                                      grouped_matmul_reference)
    R, K, N = TP_GMM_CASES[name]
    xs, w, offsets = gmm_case(cuda, R, K, N, top2_offsets(R, 8, R), torch.bfloat16, seed=N)
    before, tally = grouped_matmul.launches, gg.kernel_launches()
    out = grouped_matmul(xs, w, offsets)
    assert grouped_matmul.launches == before + 1
    assert gmm_launched(gg, tally) == {gmm_kernel("fwd", torch.bfloat16): 1}
    ref = grouped_matmul_reference(xs, w, offsets)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    assert flash_ratio(out, ref) <= 1


@gpu
def test_gmm_raises_instead_of_falling_back(cuda):
    from deepspeed_tpu_torch.ops.grouped_gemm import grouped_matmul
    xs, w, offsets = gmm_case(cuda, 64, 128, 128, [0, 10, 64], torch.bfloat16)
    before = grouped_matmul.launches
    with pytest.raises(ValueError, match="cannot take"):
        grouped_matmul(xs[:, :100].contiguous(), w[:, :100].contiguous(), offsets)
    with pytest.raises(ValueError, match="int32"):
        grouped_matmul(xs, w, offsets.long())
    with pytest.raises(TypeError):
        grouped_matmul(xs, w.float(), offsets)
    assert grouped_matmul.launches == before


@gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mixtral_engine_on_cuda_runs_the_kernels(cuda, dtype):
    """A tiny Mixtral served on the card: each forward launches the grouped
    GEMM 3 times and paged attention once per layer; the einsum pin
    launches no grouped GEMM and agrees with the kernel route."""
    import numpy as np
    from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2
    from deepspeed_tpu_torch.models.mixtral import MixtralConfig, MixtralForCausalLM
    from deepspeed_tpu_torch.ops.grouped_gemm import grouped_matmul
    model = MixtralForCausalLM.from_seed(MixtralConfig.tiny(dtype=dtype), seed=0,
                                         device=cuda)
    cfg = {"state_manager": {"max_ragged_sequence_count": 4,
                             "max_ragged_batch_size": 32, "max_context": 128,
                             "num_kv_blocks": 32},
           "kv_cache": {"block_size": 8,
                        "cache_dtype": "fp32" if dtype == torch.float32 else "bf16"}}
    kernel = InferenceEngineV2(model, cfg)
    plain = InferenceEngineV2(model, dict(cfg, modules={"moe": "einsum"}))
    assert (kernel.moe_impl, plain.moe_impl) == ("cuda_gmm", "einsum")
    ids = np.arange(19, dtype=np.int32)
    L = model.config.num_hidden_layers
    g0, p0 = grouped_matmul.launches, paged_mha.launches
    a = kernel.put([1], [ids])
    assert (grouped_matmul.launches, paged_mha.launches) == (g0 + 3 * L, p0 + L)
    b = plain.put([1], [ids])
    assert grouped_matmul.launches == g0 + 3 * L
    tol = 1e-4 if dtype == torch.float32 else 0.05 * np.abs(b).max()
    np.testing.assert_allclose(a, b, atol=tol, rtol=0)


# ---------------------------------------------------------------------------
# grouped GEMM backward (dx and dW, megablox's custom VJP)
# ---------------------------------------------------------------------------
#
# Tolerance: the forward's. dx and dW multiply the same bf16 (exact in fp32)
# or fp32 values as their plain versions, sum in fp32 in another order and
# round once, so the flash form RTOL * (|plain| + rms(plain)) holds them; a
# dW slice of an expert with no rows must be exactly zero.


def gmm_bwd_case(dev, R, K, N, offsets, dtype, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    E = len(offsets) - 1
    xs = torch.randn(R, K, generator=g, device=dev).to(dtype)
    w = (torch.randn(E, K, N, generator=g, device=dev) * K ** -0.5).to(dtype)
    dy = torch.randn(R, N, generator=g, device=dev).to(dtype)
    return xs, w, dy, torch.tensor(offsets, dtype=torch.int32, device=dev)


@pytest.mark.parametrize("name", list(GMM_CASES))
def test_gmm_backward_bound_rejects_shifted_offset(name):
    from deepspeed_tpu_torch.ops.grouped_gemm import (grouped_matmul_dw_reference,
                                                      grouped_matmul_dx_reference)
    R, K, N, offs = GMM_CASES[name]
    xs, w, dy, offsets = gmm_bwd_case(torch.device("cpu"), R, K, N, offs,
                                      torch.bfloat16)
    bad = torch.tensor(shifted(offs), dtype=torch.int32)
    for plain, args in ((grouped_matmul_dx_reference, (dy, w)),
                        (grouped_matmul_dw_reference, (xs, dy))):
        ref = plain(*args, offsets)
        x = ref.float()
        ulp = torch.finfo(ref.dtype).eps * torch.exp2(torch.floor(torch.log2(x.abs())))
        assert flash_ratio((x + ulp).to(ref.dtype), ref) <= 1
        assert flash_ratio(plain(*args, bad), ref) > 10


@gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("name", list(GMM_CASES))
def test_gmm_dx_dw_kernels_match_plain(cuda, name, dtype):
    from deepspeed_tpu_torch.ops.grouped_gemm import (grouped_matmul_dw,
                                                      grouped_matmul_dw_reference,
                                                      grouped_matmul_dx,
                                                      grouped_matmul_dx_reference)
    from deepspeed_tpu_torch.ops import grouped_gemm as gg
    R, K, N, offs = GMM_CASES[name]
    xs, w, dy, offsets = gmm_bwd_case(cuda, R, K, N, offs, dtype, seed=R)
    before = (grouped_matmul_dx.launches, grouped_matmul_dw.launches)
    tally = gg.kernel_launches()
    dx = grouped_matmul_dx(dy, w, offsets)
    dw = grouped_matmul_dw(xs, dy, offsets)
    assert (grouped_matmul_dx.launches, grouped_matmul_dw.launches) == \
        (before[0] + 1, before[1] + 1)
    assert gmm_launched(gg, tally) == {gmm_kernel("dx", dtype): 1, gmm_kernel("dw", dtype): 1}
    torch.cuda.synchronize()
    assert dx.shape == (R, K) and dw.shape == (len(offs) - 1, K, N)
    assert torch.isfinite(dx).all() and torch.isfinite(dw).all()
    assert flash_ratio(dx, grouped_matmul_dx_reference(dy, w, offsets)) <= 1
    assert flash_ratio(dw, grouped_matmul_dw_reference(xs, dy, offsets)) <= 1
    for e in range(len(offs) - 1):
        if offs[e + 1] == offs[e]:
            assert torch.count_nonzero(dw[e]) == 0, e


@gpu
def test_gmm_autograd_on_cuda(cuda):
    """grouped_matmul under autograd launches the forward, dx and dW kernels
    once each and gives the gradients of the plain forward's autograd."""
    from deepspeed_tpu_torch.ops import grouped_gemm as gg
    xs, w, dy, offsets = gmm_bwd_case(cuda, 200, 128, 256, [0, 50, 50, 150, 200],
                                      torch.bfloat16)
    a, b = xs.clone().requires_grad_(), w.clone().requires_grad_()
    before = (gg.grouped_matmul.launches, gg.grouped_matmul_dx.launches,
              gg.grouped_matmul_dw.launches)
    tally = gg.kernel_launches()
    out = gg.grouped_matmul(a, b, offsets)
    out.backward(dy)
    assert (gg.grouped_matmul.launches, gg.grouped_matmul_dx.launches,
            gg.grouped_matmul_dw.launches) == tuple(n + 1 for n in before)
    assert gmm_launched(gg, tally) == {"fwd_wgmma": 1, "dx_wgmma": 1, "dw_wgmma": 1}
    pa, pb = xs.clone().requires_grad_(), w.clone().requires_grad_()
    gg.grouped_matmul_reference(pa, pb, offsets).backward(dy)
    assert flash_ratio(a.grad, pa.grad) <= 1
    assert flash_ratio(b.grad, pb.grad) <= 1
    assert torch.count_nonzero(b.grad[1]) == 0


@gpu
def test_gmm_backward_raises_instead_of_falling_back(cuda):
    from deepspeed_tpu_torch.ops import grouped_gemm as gg
    xs, w, dy, offsets = gmm_bwd_case(cuda, 64, 128, 128, [0, 10, 64], torch.bfloat16)
    before = (gg.grouped_matmul_dx.launches, gg.grouped_matmul_dw.launches)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        gg.grouped_matmul_dx(dy.half(), w.half(), offsets)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        gg.grouped_matmul_dw(xs.half(), dy.half(), offsets)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        gg.grouped_matmul(xs.half().requires_grad_(), w.half(), offsets)
    with pytest.raises(ValueError, match="cannot take"):
        gg.grouped_matmul_dw(xs[:, :100].contiguous(), dy, offsets)
    with pytest.raises(ValueError, match="int32"):
        gg.grouped_matmul_dx(dy, w, offsets.long())
    with pytest.raises(TypeError):
        gg.grouped_matmul_dw(xs, dy.float(), offsets)
    assert (gg.grouped_matmul_dx.launches, gg.grouped_matmul_dw.launches) == before


@gpu
def test_mixtral_training_on_cuda_runs_the_kernels(cuda):
    """A tiny Mixtral (grouped-GEMM dispatch) trained through initialize on
    the card: per layer and micro-step the grouped forward launches 6 times
    (3 products, recomputed by activation checkpointing), dx and dW 3 times
    each, the flash forward twice and dq, dk/dv once; the loss falls. At lr
    1e-3 (not the Llama test's 1e-2, at which this tiny MoE's loss
    oscillates) it falls by ~0.15 a step on the CPU's plain versions."""
    import numpy as np
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.mixtral import MixtralConfig, MixtralForCausalLM
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops import grouped_gemm as gg
    cfg = MixtralConfig.tiny(dtype=torch.float32, moe_backend="gmm")
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=MixtralForCausalLM.from_seed(cfg, seed=0, device=cuda),
        config={"train_batch_size": 4, "gradient_accumulation_steps": 2,
                "bf16": {"enabled": True},
                "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}}})
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 100))
    batch = {"input_ids": ids, "labels": ids}
    fa.reset_launch_counts()
    counted = (gg.grouped_matmul, gg.grouped_matmul_dx, gg.grouped_matmul_dw)
    for f in counted:
        f.launches = 0
    tally, flash_tally = gg.kernel_launches(), fa.kernel_launches()
    losses = [float(engine.train_batch(iter([batch] * 2))) for _ in range(3)]
    L, micro = cfg.num_hidden_layers, 6
    assert tuple(f.launches for f in counted) == (6 * L * micro, 3 * L * micro,
                                                  3 * L * micro)
    assert (fa.flash_mha_fwd.launches, fa.flash_mha_bwd_dq.launches,
            fa.flash_mha_bwd_dkv.launches) == (2 * L * micro, L * micro, L * micro)
    # a micro-batch's 400 expert rows over 4 experts take the wgmma kernels
    assert gmm_launched(gg, tally) == {"fwd_wgmma": 6 * L * micro, "dx_wgmma": 3 * L * micro,
                                       "dw_wgmma": 3 * L * micro}
    assert {n: c - flash_tally[n] for n, c in fa.kernel_launches().items()
            if c > flash_tally[n]} == {"fwd_wgmma": 2 * L * micro, "dq_wgmma": L * micro,
                                       "dkv_wgmma": L * micro}
    assert losses[-1] < losses[0]


# ---------------------------------------------------------------------------
# moe_ffn_gmm_rows (kernel row 9b): the expert-parallel receiving shard's FFN
# ---------------------------------------------------------------------------
#
# Three grouped products with the gated activation between them, on the
# forward kernel (and, under autograd, the dx and dW kernels), against the
# same function on the plain grouped products. Tolerance: the output, the
# flash form scaled by 2 in bf16 (one rounding of the output plus the rare
# one-ulp flips of the two bf16 intermediates it sums; fp32: the flash form,
# no rounding of the intermediates). The gradients (of x over its real
# rows, and of w1, w2, w3) by the flash form scaled by ROWS_GRAD_SCALE: in
# bf16 they pass through the gated activation's backward several roundings
# deep, and the scale is chip_smoke.py's, set from its sound readings at
# full width on the H100 (PERF.md); fp32 by the flash form. A misrouted row
# must exceed the gradient bound (test_gmm_rows_bound_rejects_a_misrouted_row).
# Rows tagged E (the receive buffer's zero padding) must come back exactly
# 0, with a zero input gradient.

ROWS_SCALE = {torch.bfloat16: 2.0, torch.float32: 1.0}
ROWS_GRAD_SCALE = {torch.bfloat16: 8.0, torch.float32: 1.0}
ROWS_CASES = {
    # name: D, F, E, per-sender real row counts, send slots per sender, routing
    "small_sentinels": (128, 256, 2, [30, 0, 17, 45], 64, "random"),
    "small_one_empty": (128, 256, 2, [10, 20, 5, 1], 32, "one_expert"),
    "full_width_ep4": (4096, 14336, 2, [4100, 4020, 4160, 4104], 16384, "random"),
}


def rows_case(dev, name, dtype, seed=0):
    """x_rows [senders * slots, D] with each sender's real rows first and
    zero sentinel rows (id E) after them, ids, and the weights."""
    D, F, E, counts, slots, routing = ROWS_CASES[name]
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.zeros(len(counts) * slots, D, device=dev)
    ids = torch.full((len(counts) * slots,), E, dtype=torch.int32, device=dev)
    for b, n in enumerate(counts):
        x[b * slots:b * slots + n] = torch.randn(n, D, generator=g, device=dev)
        ids[b * slots:b * slots + n] = 0 if routing == "one_expert" else torch.randint(
            0, E, (n,), generator=g, device=dev, dtype=torch.int32)
    w1, w3 = ((torch.randn(E, D, F, generator=g, device=dev) * D ** -0.5).to(dtype)
              for _ in range(2))
    w2 = (torch.randn(E, F, D, generator=g, device=dev) * F ** -0.5).to(dtype)
    return x.to(dtype), ids, w1, w2, w3


def rows_ratio(out, ref):
    return flash_ratio(out, ref) / ROWS_SCALE[ref.dtype]


def rows_grads(x, ids, w1, w2, w3, dy, matmul):
    """(output, gradients of x, w1, w2, w3) of moe_ffn_gmm_rows under dy."""
    from deepspeed_tpu_torch.ops import grouped_gemm as gg
    leaves = [t.clone().requires_grad_() for t in (x, w1, w2, w3)]
    out = gg.moe_ffn_gmm_rows(leaves[0], ids, *leaves[1:], n_experts=w1.shape[0],
                              dtype=x.dtype, matmul=matmul)
    out.backward(dy)
    return out.detach(), [t.grad for t in leaves]


def rows_grad_ratios(grads, ref_grads, ids):
    """The flash-form ratio of each gradient in units of ROWS_GRAD_SCALE,
    the input gradient over its real rows."""
    real = ids < ref_grads[1].shape[0]
    scale = ROWS_GRAD_SCALE[ref_grads[0].dtype]
    return [flash_ratio(g[real] if i == 0 else g, r[real] if i == 0 else r) / scale
            for i, (g, r) in enumerate(zip(grads, ref_grads))]


def rows_dy(dev, x, ids, E):
    g = torch.Generator(device=dev).manual_seed(9)
    return torch.randn(x.shape, generator=g, device=dev).to(x.dtype) * (ids < E)[:, None]


def test_gmm_rows_bound_rejects_a_misrouted_row():
    """The plain version with one real row sent to the other expert fails
    the output bound and the gradient bound; the plain version against
    itself moved by one ulp passes the output bound."""
    from deepspeed_tpu_torch.ops import grouped_gemm as gg
    x, ids, w1, w2, w3 = rows_case(torch.device("cpu"), "small_sentinels", torch.bfloat16)
    dy = rows_dy(torch.device("cpu"), x, ids, 2)
    ref, ref_grads = rows_grads(x, ids, w1, w2, w3, dy, gg.grouped_matmul_reference)
    r = ref.float()
    ulp = torch.finfo(ref.dtype).eps * torch.exp2(torch.floor(torch.log2(r.abs())))
    assert rows_ratio(torch.where(r != 0, r + ulp, r).to(ref.dtype), ref) <= 1
    bad = ids.clone()
    bad[0] = 1 - bad[0]
    wrong, wrong_grads = rows_grads(x, bad, w1, w2, w3, dy, gg.grouped_matmul_reference)
    assert rows_ratio(wrong, ref) > 10
    assert max(rows_grad_ratios(wrong_grads, ref_grads, ids)) > 10
    assert not ref[ids == 2].any()


@gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("name", list(ROWS_CASES))
def test_gmm_rows_kernels_match_plain(cuda, name, dtype):
    """Forward and, under autograd, the gradients of x and the three
    weights: kernels against the plain grouped products; 3 forward launches
    and one count of the 9b wrapper, 3 dx and 3 dW launches."""
    from deepspeed_tpu_torch.ops import grouped_gemm as gg
    if name == "full_width_ep4" and dtype == torch.float32:
        pytest.skip("full width runs in bf16, the training dtype")
    x, ids, w1, w2, w3 = rows_case(cuda, name, dtype)
    E = w1.shape[0]
    dy = rows_dy(cuda, x, ids, E)
    results = []
    for matmul in (gg.grouped_matmul, gg.grouped_matmul_reference):
        counted = (gg.moe_ffn_gmm_rows, gg.grouped_matmul, gg.grouped_matmul_dx,
                   gg.grouped_matmul_dw)
        counts, tally = [f.launches for f in counted], gg.kernel_launches()
        out, grads = rows_grads(x, ids, w1, w2, w3, dy, matmul)
        counts = [f.launches - c for f, c in zip(counted, counts)]
        results.append((out, grads, counts, gmm_launched(gg, tally)))
    (out, grads, counts, kernels), (ref, ref_grads, plain_counts, _) = results
    torch.cuda.synchronize()
    assert counts == [1, 3, 3, 3] and plain_counts == [0, 0, 0, 0]
    assert kernels == {gmm_kernel("fwd", dtype): 3, gmm_kernel("dx", dtype): 3,
                       gmm_kernel("dw", dtype): 3}
    assert torch.isfinite(out).all() and not out[ids == E].any()
    assert rows_ratio(out, ref) <= 1
    assert not grads[0][ids == E].any()
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    ratios = rows_grad_ratios(grads, ref_grads, ids)
    assert max(ratios) <= 1, dict(zip(("dx", "dw1", "dw2", "dw3"), ratios))


# ---------------------------------------------------------------------------
# qgZ quantize / dequantize-reduce (csrc/quant_collective.cu)
# ---------------------------------------------------------------------------
#
# The kernels and their plain versions do the same IEEE operations in the
# same order (one division each for the scale and the value, round half to
# even, then per peer one product and one sum from zero), so the ints and
# scales must be equal and the sums equal bit for bit.

QUANT_CASES = {
    # name: (P peers, m per peer, bits, dtype, group size, how the wire is
    # read back, what lies under the data, the routes the source declares
    # for quantize (warp: groups of 1-8 KB) and for dequantize-reduce
    # (stream: P wire rows in 16 KB, P <= 8). "reduce": the P rows are
    # peers summed by block_dequantize_reduce; "rows": block_dequantize of
    # the P rows (one peer each, phase 13's int8 wire). "offset": x and the
    # wire start 4 and 1 bytes into their buffers (views that are not
    # 16-byte aligned).
    "int4_p4": (4, 3 * 2048 + 5, 4, torch.float32, 2048, "reduce", None, "block", "block"),
    "int8_p2": (2, 5000, 8, torch.float32, 2048, "reduce", None, "warp", "stream"),
    "one_padded_group": (4, 1024, 4, torch.float32, 2048, "reduce", None, "warp", "stream"),
    "p1_dequantize": (1, 4096, 8, torch.float32, 2048, "reduce", None, "warp", "stream"),
    "bf16_input": (4, 8192, 4, torch.bfloat16, 2048, "reduce", None, "warp", "stream"),
    "odd_group_scalar_path": (3, 1001, 8, torch.float32, 250, "reduce", None, "block",
                              "block"),
    "int4_group_6": (2, 100, 4, torch.float32, 6, "reduce", None, "block", "block"),
    "p3_gs4096_int4_ragged": (3, 3 * 4096 + 512, 4, torch.float32, 4096, "reduce", None,
                              "block", "stream"),
    "p3_int8_ragged": (3, 2 * 2048 + 1000, 8, torch.float32, 2048, "reduce", None, "warp",
                       "stream"),
    "p8_int4": (8, 2 * 2048, 4, torch.float32, 2048, "reduce", None, "warp", "stream"),
    "p8_int8_full_stage": (8, 2048 + 256, 8, torch.float32, 2048, "reduce", None, "warp",
                           "stream"),
    "p8_gs4096_int8": (8, 4096, 8, torch.float32, 4096, "reduce", None, "block", "block"),
    "p2_gs4096_int8_bf16": (2, 2 * 4096, 8, torch.bfloat16, 4096, "reduce", None, "warp",
                            "stream"),
    "p9_int4": (9, 4096, 4, torch.float32, 2048, "reduce", None, "warp", "block"),
    "bf16_int8_rows": (4, 3 * 2048 + 8, 8, torch.bfloat16, 2048, "rows", None, "warp",
                       "stream"),
    "offset_view": (4, 4096, 4, torch.float32, 2048, "reduce", "offset", "block", "block"),
    "group_250_int4": (2, 4000, 4, torch.float32, 250, "reduce", None, "block", "block"),
    "p2_gs256_int4_ragged": (2, 3 * 256 + 64, 4, torch.float32, 256, "reduce", None, "warp",
                             "stream"),
    "bf16_gs256_int8": (2, 1024, 8, torch.bfloat16, 256, "reduce", None, "block", "stream"),
}


def same_bits(a, b):
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def quant_plain(x, bits, gs):
    from deepspeed_tpu_torch.ops import quant_collective as qc
    rows, R, G = qc._prep_rows(x, gs)
    q, s = qc._quantize_rows_ref(rows, bits)
    return q.reshape(R, -1), s.reshape(R, G)


def offset_copy(t, nbytes):
    """``t`` copied into a fresh buffer ``nbytes`` bytes past its start: a
    contiguous view whose data pointer is not 16-byte aligned."""
    item = t.element_size()
    buf = torch.empty(t.numel() + 16 // item, dtype=t.dtype, device=t.device)
    view = buf[nbytes // item:nbytes // item + t.numel()].view(t.shape)
    view.copy_(t)
    return view


def neighbour_scales(s):
    """The planted fault: group 1 of row 0 reads group 0's scale (row 1's
    group 0 where a row has one group)."""
    bad = s.clone()
    if s.shape[1] > 1:
        bad[0, 1] = s[0, 0]
    else:
        bad[0, 0] = s[1, 0] if s.shape[0] > 1 else 2 * s[0, 0]
    return bad


def test_quant_exact_check_rejects_a_neighbour_scale():
    """A group dequantized with its neighbour's scale is not bit-equal to
    the plain sum (the comparison below can fail)."""
    from deepspeed_tpu_torch.ops import quant_collective as qc
    x = torch.randn(4, 3 * 2048, generator=torch.Generator().manual_seed(0))
    q, s = qc.block_quantize(x, num_bits=4)
    bad = s.clone()
    bad[0, 1] = s[0, 0]
    assert not same_bits(qc.block_dequantize_reduce(q, s, num_bits=4),
                         qc.block_dequantize_reduce(q, bad, num_bits=4))


@gpu
@pytest.mark.parametrize("name", list(QUANT_CASES))
def test_quant_kernels_match_plain(cuda, name):
    """Ints, scales and sums bitwise equal to the plain versions; the
    source declares the case's routes and the tally shows one launch on
    each; the plain sum with a neighbour's scale differs."""
    from deepspeed_tpu_torch.ops import quant_collective as qc
    P, m, bits, dtype, gs, read, under, q_route, d_route = QUANT_CASES[name]
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(P, m, generator=g, device=cuda)
    x[0, :gs] *= 50.0
    if P > 1:
        x[P - 1, :min(gs, m)] = 0.0           # an all-zero group: scale 1
    x = x.to(dtype)
    if under == "offset":
        x = offset_copy(x, 4)
    aligned = under != "offset"
    assert qc.kernel_route("quantize", m, gs, bits, dtype, aligned=aligned) == \
        f"quantize_{q_route}"
    before = (qc.block_quantize.launches, qc.block_dequantize_reduce.launches)
    tally = qc.kernel_launches()
    q, s = qc.block_quantize(x, num_bits=bits, group_size=gs)
    q_ref, s_ref = quant_plain(x, bits, gs)
    assert same_bits(q, q_ref) and same_bits(s, s_ref)
    if P > 1:
        assert bool((s[P - 1, 0] == 1.0).item())
    G = s.shape[1]
    if under == "offset":
        q = offset_copy(q, 1)
    peers, out_rows = (P, 1) if read == "reduce" else (1, P)
    assert qc.kernel_route("dequantize_reduce", m, gs, bits, peers=peers,
                           aligned=aligned) == f"dequant_reduce_{d_route}"
    if read == "rows" or P == 1:
        deq = lambda scales: qc.block_dequantize(q, scales, num_bits=bits, group_size=gs,
                                                 out_len=m)
    else:
        deq = lambda scales: qc.block_dequantize_reduce(q, scales, num_bits=bits,
                                                        group_size=gs, out_len=m)
    out = deq(s)
    wire = q.reshape(peers, out_rows * G, -1)
    plain = lambda scales: qc._dequantize_reduce_ref(
        wire, scales.reshape(peers, -1), bits).reshape(out_rows, -1)[:, :m].reshape(out.shape)
    torch.cuda.synchronize()
    assert same_bits(out, plain(s))
    assert not same_bits(out, plain(neighbour_scales(s)))
    assert (qc.block_quantize.launches, qc.block_dequantize_reduce.launches) == \
        (before[0] + 1, before[1] + 1)
    launched = {n: c - tally[n] for n, c in qc.kernel_launches().items() if c > tally[n]}
    assert launched == {f"quantize_{q_route}": 1, f"dequant_reduce_{d_route}": 1}


# Llama-2-7B's quantized leaves as the port holds them ([out, in]), the
# axis qwZ groups them along (0: an nn.Linear weight, whose JAX kernel is
# [in, out]) and the route at world 4: q_proj cut along its outputs into
# 1024 a rank, 4 whole groups (column chunks of the JAX layout); gate_proj
# [11008, 4096] cut along its 11008 outputs, 2752 a rank, 10.75 groups
# ("rows": each rank quantizes a block of whole rows); down_proj cut along
# its inputs and lm_head [32000, 4096] along the vocabulary (row chunks)
QWZ_LEAVES = {"q_proj": ((4096, 4096), 0, "chunk"), "gate_proj": ((11008, 4096), 0, "rows"),
              "down_proj": ((4096, 11008), 0, "chunk"),
              "lm_head": ((32000, 4096), -1, "chunk")}


@gpu
@pytest.mark.parametrize("name", list(QWZ_LEAVES))
def test_qwz_route_is_quantize_lastdim(cuda, name):
    """qwZ's quantize (``zero/qwz.quantize_rows``: row 5 on the bf16 rows
    widened to fp32) and dequantize (``dequantize_leaf``: row 6 with one
    peer, cast once to bf16) on the card, bit for bit against the plain
    ``quantize_lastdim`` / ``dequantize_lastdim`` (``ops/quantizer``, held
    to the JAX package's on the CPU) of the whole leaf in the JAX layout:
    on each rank's piece as the route at world 4 takes it (a column chunk
    of whole groups, a row chunk, or gate_proj's row block of whole rows
    where its 2752-output chunk straddles groups); the routes are the
    source's ``quantize_warp`` and ``dequant_reduce_stream``; a scale
    doubled on one group fails."""
    from deepspeed_tpu_torch.ops import quant_collective as qc
    from deepspeed_tpu_torch.ops.quantizer import dequantize_lastdim, quantize_lastdim
    from deepspeed_tpu_torch.runtime.zero import qwz
    from deepspeed_tpu_torch.runtime.zero.partition import zero_shard_dim
    (shape, axis, want_route), W = QWZ_LEAVES[name], 4
    g = torch.Generator(device=cuda).manual_seed(len(name))
    full = (torch.randn(shape, generator=g, device=cuda) * 0.02).to(torch.bfloat16)
    jleaf = full.movedim(axis, -1).contiguous()     # the JAX layout
    jleaf[0, :256] *= 40.0                     # groups of very different scales
    jleaf[1, :256] = 0.0                       # an all-zero group: scale 1
    q_ref, s_ref = quantize_lastdim(jleaf)
    d = zero_shard_dim(shape, W)
    assert qwz.route(shape, d, W, axis=axis) == want_route
    qshape, qd = qwz.qlayout(shape, d, axis)
    gs, G = qwz.group_of(qshape[-1])
    by_rows = want_route == "rows" or qd != len(qshape) - 1
    width = qshape[-1] if by_rows else qshape[-1] // W
    assert qc.kernel_route("quantize", width, gs, 8, torch.float32) == "quantize_warp"
    assert qc.kernel_route("dequantize_reduce", qshape[-1], gs, 8, peers=1) == \
        "dequant_reduce_stream"
    rows = qshape[0] // W                      # a row chunk, or a row block
    tally = qc.kernel_launches()
    for r in range(W):
        if by_rows:
            pick, spick = (slice(r * rows, (r + 1) * rows),), (slice(r * rows, (r + 1) * rows),)
        else:
            pick = (slice(None), slice(r * width, (r + 1) * width))
            spick = (slice(None), slice(r * G // W, (r + 1) * G // W))
        q, s = qwz.quantize_rows(jleaf[pick], gs)
        assert torch.equal(q, q_ref[pick]), r
        assert same_bits(s, s_ref[spick].contiguous()), r
    back = qwz.dequantize_leaf(q_ref.movedim(-1, axis), s_ref, torch.bfloat16, axis=axis)
    torch.cuda.synchronize()
    want = dequantize_lastdim(q_ref, s_ref, dtype=torch.bfloat16).movedim(-1, axis)
    assert torch.equal(back, want)
    bad = s_ref.clone()
    bad[0, 0] *= 2
    assert not torch.equal(qwz.dequantize_leaf(q_ref.movedim(-1, axis), bad, torch.bfloat16,
                                               axis=axis), want)
    launched = {n: c - tally[n] for n, c in qc.kernel_launches().items() if c > tally[n]}
    assert launched == {"quantize_warp": W, "dequant_reduce_stream": 2}


@gpu
def test_quant_raises_instead_of_falling_back(cuda):
    from deepspeed_tpu_torch.ops import quant_collective as qc
    x = torch.randn(2, 100, device=cuda)
    before = qc.block_quantize.launches
    with pytest.raises(ValueError, match="even group_size"):
        qc.block_quantize(x, num_bits=4, group_size=7)
    with pytest.raises(ValueError, match="8 or 4"):
        qc.block_quantize(x, num_bits=3)
    assert qc.block_quantize.launches == before


@gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("pages", [1, 3, 7])
def test_quant_kernels_at_the_wire_shape(cuda, dtype, pages):
    """Rows 5-6 as the fleet's wire codec calls them: page rows [layers x
    pages x kv heads x block, 128], one group of 128 a row, on the routes
    the source declares (``quantize_block`` / ``dequant_reduce_block``),
    bit for bit against their plain versions; and a frame encoded from the
    pages on the card is the frame the CPU's plain versions encode."""
    from deepspeed_tpu_torch.inference.v2.fleet import wire
    from deepspeed_tpu_torch.ops import quant_collective as qc
    L, H, bs, hd = 4, 8, 64, 128
    g = torch.Generator(device=cuda).manual_seed(pages)
    k = torch.randn(L, pages, H, bs, hd, generator=g, device=cuda).to(dtype)
    v = torch.randn(L, pages, H, bs, hd, generator=g, device=cuda).to(dtype)
    k[0, 0, 0, 0] = 0.0                          # an all-zero row: scale 1
    rows = k.reshape(-1, hd)
    assert qc.kernel_route("quantize", hd, hd, 8, dtype) == "quantize_block"
    assert qc.kernel_route("dequantize_reduce", hd, hd, 8, peers=1) == \
        "dequant_reduce_block"
    tally = qc.kernel_launches()
    q, sc = qc.block_quantize(rows, 8, group_size=hd)
    q_ref, s_ref = quant_plain(rows, 8, hd)
    assert same_bits(q, q_ref) and same_bits(sc, s_ref)
    assert bool((sc[0, 0] == 1.0).item())
    out = qc.block_dequantize(q, sc, 8, group_size=hd, out_len=hd)
    plain = qc._dequantize_reduce_ref(q.reshape(1, -1, hd), sc.reshape(1, -1), 8)
    torch.cuda.synchronize()
    assert same_bits(out, plain.reshape(out.shape))
    launched = {n: c - tally[n] for n, c in qc.kernel_launches().items() if c > tally[n]}
    assert launched == {"quantize_block": 1, "dequant_reduce_block": 1}
    seqs = [{"uid": 0, "n": pages, "seen_tokens": pages * bs, "tokens": []}]
    on_card = wire.encode_handle({"n": pages, "k": k, "v": v, "seqs": seqs})
    on_host = wire.encode_handle({"n": pages, "k": k.cpu(), "v": v.cpu(), "seqs": seqs})
    assert on_card == on_host
    back = wire.decode_frame(on_card, cuda)
    assert back["k"].device.type == "cuda"
    assert torch.equal(back["k"].cpu(), wire.decode_frame(on_host, "cpu")["k"])


@gpu
@pytest.mark.parametrize("kv_dtype", ["fp", "int8"])
def test_export_import_blocks_across_engines_bitwise(cuda, kv_dtype):
    """A prefilled sequence's pages leave one engine on the card
    (``export_pages_many``, a copying gather) and bind in another: the bound
    pool rows equal the exported ones bit for bit, the source's blocks are
    free again, and the destination's next decode round gives the logits
    the source engine gives for the same round."""
    from deepspeed_tpu_torch.inference.v2 import build_engine
    from deepspeed_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    model = LlamaForCausalLM.from_seed(LlamaConfig.tiny(), 0, device=cuda)
    cfg = {"state_manager": {"max_ragged_sequence_count": 4, "max_ragged_batch_size": 64,
                             "max_context": 256, "num_kv_blocks": 32, "kv_dtype": kv_dtype},
           "kv_cache": {"block_size": 16, "cache_dtype": "bf16"}}
    src, dst, mono = (build_engine(model, cfg, device=cuda) for _ in range(3))
    prompt = np.arange(3, 53, dtype=np.int32)
    first = src.put([0], [prompt])
    mono.put([0], [prompt])
    free = src.free_blocks
    h = src.export_pages_many([0])
    parts = [p.clone() for pages in (h["k"], h["v"])
             for p in (pages if isinstance(pages, tuple) else (pages,))]
    assert src.free_blocks == free + h["n"]
    dst.import_pages_many(h)
    kv = dst._state.kv_cache
    idx = torch.tensor(dst._state.get_sequence(0).kv_blocks, device=cuda)
    want = parts if kv_dtype == "fp" else [parts[0], parts[2], parts[1], parts[3]]
    for pool, w in zip(kv._pools(), want):
        assert torch.equal(pool.index_select(1, idx), w)
    tok = np.asarray([int(np.argmax(first[0]))], np.int32)
    assert np.array_equal(dst.put([0], [tok]), mono.put([0], [tok]))


def _nccl_exchange_rank(rank, world, port, out):
    import os
    from deepspeed_tpu_torch.comm import comm as dist
    from deepspeed_tpu_torch.runtime.comm.coalesced_collectives import exchange_reduce
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), LOCAL_RANK=str(rank))
    dist.init_distributed(dist_backend="nccl", rank=rank, world_size=world, timeout=120)
    blocks = torch.randn(world, world, 5000, generator=torch.Generator().manual_seed(0))
    got, err = exchange_reduce(blocks[rank].cuda(), None, 4, 2048, return_error=True)
    out.put((rank, got.cpu(), err.cpu()))
    dist.barrier()
    dist.destroy_process_group()


@gpu
def test_nccl_exchange_reduce_matches_plain(cuda):
    """``exchange_reduce`` over NCCL on 2 cards against the same exchange
    computed with the plain versions on the CPU: bit-equal."""
    import socket
    import torch.multiprocessing as mp
    from deepspeed_tpu_torch.ops import quant_collective as qc
    world = torch.cuda.device_count()
    if world < 2:
        pytest.skip(f"needs 2 or more cards for an NCCL exchange; {world} visible")
    world = 2
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    ctx = mp.get_context("spawn")
    out = ctx.SimpleQueue()
    procs = [ctx.Process(target=_nccl_exchange_rank, args=(r, world, port, out))
             for r in range(world)]
    for p in procs:
        p.start()
    results = {}
    for _ in range(world):
        rank, got, err = out.get()
        results[rank] = (got, err)
    for p in procs:
        p.join(timeout=120)
        assert p.exitcode == 0
    blocks = torch.randn(world, world, 5000, generator=torch.Generator().manual_seed(0))
    wires = [qc.block_quantize(blocks[r], num_bits=4) for r in range(world)]
    for r in range(world):
        q = torch.stack([wires[p][0][r] for p in range(world)])
        s = torch.stack([wires[p][1][r] for p in range(world)])
        want = qc.block_dequantize_reduce(q, s, num_bits=4, out_len=5000)
        want_err = blocks[r] - qc.block_dequantize(*wires[r], num_bits=4, out_len=5000)
        assert same_bits(results[r][0], want)
        assert same_bits(results[r][1], want_err)


# -- W8A16 quantized matmul (kernel row 7) -----------------------------------
# Per-element bound: RTOL[out dtype] * |plain| + QMM_ACC * (|x| @ |w|), w the
# dequantized tile. Kernel and plain version round the same tile, multiply
# exactly in fp32 (bf16/fp16 products) and differ in the order of the fp32
# sums, then round once to the output dtype (the RTOL term). The sums' order
# moves a result by a few fp32 units of sum_k |x w| (random-walk growth,
# about sqrt(K) * 2^-24 = 2^-17 of it at K = 11008); QMM_ACC = 2^-16 leaves
# room for that. One scale group of one K row multiplied by 1.5 moves the
# group's outputs by 0.5 |x w| of that row, far above both terms
# (``test_qmm_bound_rejects_a_scaled_group``).
QMM_ACC = 2 ** -16
QMM_CASES = {
    # name: M, K, N, G, x dtype, out dtype
    "decode_7b_gate": (4, 4096, 11008, 256, torch.bfloat16, None),
    "decode_7b_down": (4, 11008, 4096, 256, torch.bfloat16, None),
    "m1": (1, 4096, 4096, 256, torch.bfloat16, None),
    "m13_g128": (13, 4096, 4096, 128, torch.bfloat16, None),
    "m17_ragged": (17, 1032, 528, 48, torch.bfloat16, None),
    "prefill": (300, 4096, 1024, 256, torch.bfloat16, None),
    "fp16_fp32_out": (64, 1024, 2048, 128, torch.float16, torch.float32),
    "bf16_fp16_out": (8, 512, 256, 16, torch.bfloat16, torch.float16),
    # a tp 2 rank's gate/up at Llama-2-7B, cut in whole groups of 256 (22 and
    # 21), at decode and prefill rows, and down's K the same ranges
    "decode_7b_gate_tp2_r0": (4, 4096, 5632, 256, torch.bfloat16, None),
    "decode_7b_gate_tp2_r1": (4, 4096, 5376, 256, torch.bfloat16, None),
    "prefill_7b_gate_tp2_r0": (1024, 4096, 5632, 256, torch.bfloat16, None),
    "prefill_7b_gate_tp2_r1": (1024, 4096, 5376, 256, torch.bfloat16, None),
    "decode_7b_down_tp2_r1": (4, 5376, 4096, 256, torch.bfloat16, None),
}


def qmm_case(M, K, N, G, dtype, dev, seed=0):
    from deepspeed_tpu_torch.ops.quantizer import quantize_lastdim
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(M, K, generator=g, device=dev).to(dtype)
    w = torch.randn(K, N, generator=g, device=dev) * K ** -0.5
    q, s = quantize_lastdim(w, group_size=G)
    return x, q, s


def qmm_ratio(out, ref, x, q, s, G):
    from deepspeed_tpu_torch.ops.quantizer import dequantize_lastdim
    w = dequantize_lastdim(q, s, group_size=G, dtype=x.dtype).float()
    mag = x.float().abs() @ w.abs()
    bound = RTOL[out.dtype] * ref.float().abs() + QMM_ACC * mag
    return ((out.float() - ref.float()).abs() / bound.clamp(min=1e-30)).max().item()


def scaled_group(x, s):
    """The planted fault: the first scale group of x's largest K row times 1.5."""
    bad = s.clone()
    k = int(x.float().abs().amax(0).argmax())
    bad[k, 0] *= 1.5
    return bad


def test_qmm_bound_rejects_a_scaled_group():
    from deepspeed_tpu_torch.ops.quantized_matmul import quantized_matmul_reference
    x, q, s = qmm_case(4, 1024, 512, 128, torch.bfloat16, torch.device("cpu"))
    ref = quantized_matmul_reference(x, q, s, 128)
    assert qmm_ratio(ref, ref, x, q, s, 128) == 0
    bad = quantized_matmul_reference(x, q, scaled_group(x, s), 128)
    assert qmm_ratio(bad, ref, x, q, s, 128) > 4


@gpu
@pytest.mark.parametrize("name", list(QMM_CASES))
def test_qmm_kernel_matches_plain(cuda, name):
    from deepspeed_tpu_torch.ops import quantized_matmul as qm
    M, K, N, G, dtype, out_dtype = QMM_CASES[name]
    x, q, s = qmm_case(M, K, N, G, dtype, cuda)
    want = qm.kernel_route(M)
    assert want == ("decode_mma" if M <= qm.DECODE_MAX_ROWS else "prefill_wgmma")
    assert qm.plan(M, K, N, torch.cuda.get_device_properties(0).multi_processor_count)[0] == want
    before, tally = qm.quantized_matmul.launches, qm.kernel_launches()
    out = qm.quantized_matmul(x, q, s, G, out_dtype=out_dtype)
    after = qm.kernel_launches()
    ref = qm.quantized_matmul_reference(x, q, s, G, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert qm.quantized_matmul.launches == before + 1
    assert {n: after[n] - tally[n] for n in after if after[n] > tally[n]} == {want: 1}
    assert out.dtype == (out_dtype or dtype) and out.shape == (M, N)
    assert torch.isfinite(out).all()
    assert qmm_ratio(out, ref, x, q, s, G) <= 1
    bad = qm.quantized_matmul_reference(x, q, scaled_group(x, s), G, out_dtype=out_dtype)
    assert qmm_ratio(bad, ref, x, q, s, G) > 1


@gpu
def test_qmm_raises_instead_of_falling_back(cuda):
    from deepspeed_tpu_torch.ops import quantized_matmul as qm
    x, q, s = qmm_case(4, 512, 256, 128, torch.bfloat16, cuda)
    before = qm.quantized_matmul.launches
    with pytest.raises(ValueError, match="bf16 or fp16"):
        qm.quantized_matmul(x.float(), q, s, 128)
    qb, sb = q[:, :200].contiguous(), s[:, :1].contiguous()
    with pytest.raises(ValueError, match="N=200"):
        qm.quantized_matmul(x, qb, sb, 128)
    assert qm.quantized_matmul.launches == before


@gpu
def test_quantized_engine_on_cuda_runs_the_kernel(cuda):
    """A tiny Llama served int8 through init_inference on the card: every
    Dense product of a forward launches the kernel once, and the logits
    agree with the same engine pinned to dense_dequant."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.inference.quantization import QuantizedLinear
    from deepspeed_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from deepspeed_tpu_torch.ops import quantized_matmul as qm
    cfg = LlamaConfig.tiny()
    engine = deepspeed_tpu_torch.init_inference(
        LlamaForCausalLM.from_seed(cfg, seed=0, device=cuda),
        config={"dtype": "bf16", "quant": {"enabled": True, "bits": 8, "group_size": 256}})
    ids = torch.randint(0, cfg.vocab_size, (2, 16), device=cuda)
    before = qm.quantized_matmul.launches
    fused = engine(ids).float()
    assert qm.quantized_matmul.launches == before + 7 * cfg.num_hidden_layers
    linears = [m for m in engine.module.modules()
               if isinstance(m, QuantizedLinear) and m.layout == "kn"]
    for m in linears:
        m.set_impl("dense_dequant")
    dense = engine(ids).float()
    assert ((fused - dense).norm() / dense.norm()).item() < 2e-2
    assert engine.generate(ids, max_new_tokens=4).shape == (2, 4)


# ---------------------------------------------------------------------------
# block-sparse attention (kernel row 8, csrc/block_sparse_attention.cu)
# ---------------------------------------------------------------------------
# The flash kernels' bound (flash_ratio): kernel and plain version compute
# in fp32 from the same inputs and round p to v's dtype at the same running
# maxima (whole key blocks), but their fp32 logits differ in the last bits,
# so p flips a rounding now and then; in a row of few keys whose output
# nearly cancels that exceeds one unit in the element's last place (the
# paged bound read 9.5 at block 16 on the H100, this one 0.54). The
# tensor-core kernel's q.k sums differ more (a truncating sum), so its
# cases add ``sparse_flip_slack``, which admits exactly those flips, and
# ``sparse_probe`` holds its rounding point with no slack. The planted fault
# moves one cols entry of the plain version by one block.

SPARSE_CASES = {
    # B, H, S, D, block, dtype, config, kwargs, causal
    "fixed_b64_causal": (1, 4, 1024, 128, 64, torch.bfloat16, "Fixed",
                         dict(attention="unidirectional"), True),
    "bigbird_b64": (1, 4, 1024, 128, 64, torch.bfloat16, "BigBird", {}, False),
    "fixed_b16": (1, 4, 512, 128, 16, torch.bfloat16, "Fixed",
                  dict(attention="unidirectional"), True),
    "fixed_b32_d64_batch2": (2, 4, 512, 64, 32, torch.bfloat16, "Fixed",
                             dict(attention="unidirectional"), True),
    "fixed_b128": (1, 4, 2048, 128, 128, torch.bfloat16, "Fixed",
                   dict(attention="unidirectional"), True),
    "fixed_d256": (1, 2, 1024, 256, 64, torch.bfloat16, "Fixed",
                   dict(attention="unidirectional"), True),
    "per_head": (1, 4, 1024, 128, 64, torch.bfloat16, "Fixed",
                 dict(different_layout_per_head=True,
                      num_different_global_patterns=4), False),
    "block8": (1, 2, 256, 64, 8, torch.bfloat16, "Fixed", {}, True),
    "block24_d96": (1, 2, 480, 96, 24, torch.bfloat16, "Fixed", {}, True),
    "block72": (1, 2, 576, 128, 72, torch.bfloat16, "BSLongformer", {}, True),
    "empty_row": (1, 4, 512, 128, 64, torch.bfloat16, "Fixed",
                  dict(attention="unidirectional"), True),
    "fp16": (1, 4, 1024, 128, 64, torch.float16, "Fixed",
             dict(attention="unidirectional"), True),
    "fp32": (1, 4, 1024, 128, 64, torch.float32, "Fixed",
             dict(attention="unidirectional"), True),
}


def sparse_case(name, dev, seed=0):
    import numpy as np
    from deepspeed_tpu_torch.ops import block_sparse_attention as bsa
    from deepspeed_tpu_torch.ops import sparse_attention as sa
    B, H, S, D, block, dtype, cfg, kw, causal = SPARSE_CASES[name]
    layout = getattr(sa, f"{cfg}SparsityConfig")(num_heads=H, block=block,
                                                  **kw).make_layout(S)
    if name == "empty_row":
        layout[1, 5] = 0
    cols, counts = bsa.compact_layout(layout, causal, block)
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn(B, H, S, D, generator=g, device=dev).to(dtype)
               for _ in range(3))
    return (q, k, v, torch.from_numpy(cols).to(dev), torch.from_numpy(counts).to(dev),
            block, causal, D ** -0.5), np.asarray(cols), np.asarray(counts)


def moved_cols(cols, counts, causal):
    """cols with one enabled entry moved by one block to a block its row does
    not enable (not above the diagonal with causal)."""
    nq = cols.shape[1]
    bad = cols.copy()
    for h in range(cols.shape[0]):
        for iq in range(nq - 1, -1, -1):
            row = set(cols[h, iq, :counts[h, iq]].tolist())
            for j in range(counts[h, iq]):
                for step in (-1, 1):
                    new = int(cols[h, iq, j]) + step
                    if 0 <= new < nq and new not in row and (not causal or new <= iq):
                        bad[h, iq, j] = new
                        return torch.from_numpy(bad)
    raise AssertionError("no cols entry can move by one block")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_sparse_bound_rejects_a_moved_block(dtype):
    from deepspeed_tpu_torch.ops.block_sparse_attention import sparse_mha_fwd_reference
    args, cols, counts = sparse_case("fixed_b64_causal", torch.device("cpu"))
    args = tuple(a.to(dtype) if i < 3 else a for i, a in enumerate(args))
    ref = sparse_mha_fwd_reference(*args)
    x = ref.float()
    ulp = torch.finfo(dtype).eps * torch.exp2(torch.floor(torch.log2(x.abs().clamp(min=1e-30))))
    assert flash_ratio((x + ulp).to(dtype), ref) <= 1
    q, k, v, _, cnt, block, causal, scale = args
    bad = sparse_mha_fwd_reference(q, k, v, moved_cols(cols, counts, causal), cnt,
                                   block, causal, scale)
    assert flash_ratio(bad, ref) > 10


def sparse_slack(args):
    """``sparse_flip_slack`` where the route is the tensor-core kernel's,
    else None (the SIMT kernel sums q.k in fp32 FMAs, held with no slack)."""
    from deepspeed_tpu_torch.ops import block_sparse_attention as bsa
    q, block = args[0], args[5]
    if bsa.kernel_route(q.dtype, block, q.shape[-1]) != "fwd_wgmma":
        return None
    return sparse_flip_slack(*args)


@gpu
@pytest.mark.parametrize("name", list(SPARSE_CASES))
def test_sparse_kernel_matches_plain(cuda, name):
    """Each case launches the kernel its route names (by the library's
    tally) and holds the plain version's flash form, plus the flip slack on
    the tensor-core route; the moved cols entry fails that bound."""
    from deepspeed_tpu_torch.ops import block_sparse_attention as bsa
    args, cols, counts = sparse_case(name, cuda)
    q, k, v, _, cnt, block, causal, scale = args
    before, tally = bsa.sparse_mha_fwd.launches, bsa.kernel_launches()
    out = bsa.sparse_mha_fwd(*args)
    launched = {n: c - tally[n] for n, c in bsa.kernel_launches().items() if c > tally[n]}
    ref = bsa.sparse_mha_fwd_reference(*args)
    slack = sparse_slack(args)
    torch.cuda.synchronize()
    assert bsa.sparse_mha_fwd.launches == before + 1
    assert launched == {bsa.kernel_route(q.dtype, block, q.shape[-1]): 1}
    assert out.shape == ref.shape and out.dtype == ref.dtype
    assert torch.isfinite(out).all()
    assert flash_ratio(out, ref, slack) <= 1
    bad = bsa.sparse_mha_fwd_reference(q, k, v, moved_cols(cols, counts, causal).to(cuda),
                                       cnt, block, causal, scale)
    assert flash_ratio(bad, ref, slack) > 1
    if name == "empty_row":
        assert (out[:, 1, 5 * block:6 * block] == 0).all()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("block", [64, 128])
def test_sparse_probe_rejects_rounding_point_faults(block, dtype):
    """On ``sparse_probe`` the plain version's output cancels to within a
    thousandth of the bound off every 8th column, and p rounded anywhere
    else (not at all, or against the other block size's maxima) fails the
    flash form tenfold."""
    from deepspeed_tpu_torch.ops import block_sparse_attention as bsa
    args = sparse_probe(dtype, 64, block, torch.device("cpu"))
    out = bsa.sparse_mha_fwd_reference(*args)
    off = torch.arange(64) % 8 != 0
    assert out[..., off].float().abs().max() < 1e-3 * RTOL[dtype] * out.float().pow(2).mean().sqrt()
    for fault, bad in sparse_rounding_faults(*args).items():
        assert flash_ratio(bad, out) > 10, fault


class _ChunkedQK:
    """``torch`` for the plain block-sparse version with q.k summed over
    16-column chunks, as tensor cores do: the same logits in another
    summation order."""

    def __getattr__(self, name):
        return getattr(torch, name)

    @staticmethod
    def einsum(eq, a, b):
        if eq != "bhnqd,bhnkd->bhnqk":
            return torch.einsum(eq, a, b)
        return sum(torch.einsum(eq, a[..., c:c + 16], b[..., c:c + 16])
                   for c in range(0, a.shape[-1], 16))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("name", ["fixed_b64_causal", "bigbird_b64", "fixed_b128"])
def test_sparse_flip_slack_admits_reordered_logits(name, dtype):
    """The plain version computed from logits summed in another order rounds
    some p the other way; the bound with ``sparse_flip_slack`` admits it,
    and still rejects the moved cols entry."""
    from deepspeed_tpu_torch.ops import block_sparse_attention as bsa
    args, cols, counts = sparse_case(name, torch.device("cpu"))
    args = tuple(a.to(dtype) if i < 3 else a for i, a in enumerate(args))
    ref = bsa.sparse_mha_fwd_reference(*args)
    slack = sparse_flip_slack(*args)
    with mock.patch.object(bsa, "torch", _ChunkedQK()):
        reordered = bsa.sparse_mha_fwd_reference(*args)
    assert flash_ratio(reordered, ref, slack) <= 1
    q, k, v, _, cnt, block, causal, scale = args
    bad = bsa.sparse_mha_fwd_reference(q, k, v, moved_cols(cols, counts, causal), cnt, block,
                                       causal, scale)
    assert flash_ratio(bad, ref, slack) > 1


@pytest.mark.parametrize("name", ["bigbird_b64", "fixed_b128", "per_head", "empty_row"])
def test_sparse_work_order_covers_every_item_by_descending_counts(name):
    """The tensor-core kernel's work items (``work_items`` of ``work_order``,
    as the source decodes them) cover every (b, h, query row block of 64)
    exactly once, in non-increasing counts."""
    from deepspeed_tpu_torch.ops import block_sparse_attention as bsa
    _, cols, counts = sparse_case(name, torch.device("cpu"))
    B, H, S, _, block = SPARSE_CASES[name][:5]
    items = bsa.work_items(bsa.work_order(counts), B, S // block, block)
    assert sorted(items) == sorted((b, h, r // block, r) for b in range(B) for h in range(H)
                                   for r in range(0, S, 64))
    seq = [counts[h, iq] for _, h, iq, _ in items]
    assert all(a >= b for a, b in zip(seq, seq[1:]))
    assert seq[0] == counts.max() and seq[-1] == counts.min()


@gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("block", [64, 128])
@pytest.mark.parametrize("dh", [64, 128])
def test_sparse_kernel_rounds_where_plain_does(cuda, dh, block, dtype):
    """On ``sparse_probe`` the tensor-core kernel holds the flash form with
    no slack, which every rounding-point fault fails tenfold."""
    from deepspeed_tpu_torch.ops import block_sparse_attention as bsa
    args = sparse_probe(dtype, dh, block, cuda)
    tally = bsa.kernel_launches()
    out = bsa.sparse_mha_fwd(*args)
    assert bsa.kernel_launches()["fwd_wgmma"] == tally["fwd_wgmma"] + 1
    ref = bsa.sparse_mha_fwd_reference(*args)
    torch.cuda.synchronize()
    assert flash_ratio(out, ref) <= 1
    assert all(flash_ratio(bad, ref) > 10 for bad in sparse_rounding_faults(*args).values())


@gpu
@pytest.mark.parametrize("D", [64, 36])
def test_sparse_wgmma_reads_strided_views_and_pads_odd_widths(cuda, D):
    """The tensor-core route reads q/k/v as the module makes them (views of
    one [B, S, 3 H D] projection, transposed) in place at D 64, and copies a
    width TMA cannot read (36: 72-byte rows) into aligned tensors."""
    from deepspeed_tpu_torch.ops import block_sparse_attention as bsa
    from deepspeed_tpu_torch.ops.sparse_attention import FixedSparsityConfig
    B, S, H = 2, 1024, 4
    layout = FixedSparsityConfig(num_heads=H, block=64).make_layout(S)
    g = torch.Generator(device=cuda).manual_seed(4)
    base = torch.randn(B, S, 3 * H * D, generator=g, device=cuda).to(torch.bfloat16)
    q, k, v = (t.reshape(B, S, H, D).transpose(1, 2) for t in base.split(H * D, -1))
    cols, counts, order = bsa._schedule(layout, True, 64, cuda)
    args = (q, k, v, cols, counts, 64, True, D ** -0.5)
    tally = bsa.kernel_launches()
    out = bsa.sparse_mha_fwd(*args, order=order)
    assert bsa.kernel_launches()["fwd_wgmma"] == tally["fwd_wgmma"] + 1
    ref = bsa.sparse_mha_fwd_reference(*(t.contiguous() for t in (q, k, v)), *args[3:])
    torch.cuda.synchronize()
    assert out.shape == (B, H, S, D)
    assert flash_ratio(out, ref, sparse_flip_slack(*args)) <= 1


@gpu
def test_sparse_kernel_takes_strided_inputs_and_backward_is_the_plain_routes(cuda):
    """q/k/v as the module makes them (a [B, S, H, D] view transposed) run
    without a copy, and for one output gradient the kernel route's input
    gradients equal the plain route's: the backward recomputes from q, k, v
    alone."""
    import numpy as np
    from deepspeed_tpu_torch.ops import block_sparse_attention as bsa
    from deepspeed_tpu_torch.ops.sparse_attention import FixedSparsityConfig
    B, S, H, D = 1, 512, 4, 64
    layout = FixedSparsityConfig(num_heads=H, block=32).make_layout(S)
    g = torch.Generator(device=cuda).manual_seed(3)
    base = torch.randn(B, S, 3 * H * D, generator=g, device=cuda).to(torch.bfloat16)
    gout = torch.randn(B, H, S, D, generator=g, device=cuda).to(torch.bfloat16)
    grads = []
    for plain in (False, True):
        leaf = base.clone().requires_grad_()
        q, k, v = (t.reshape(B, S, H, D).transpose(1, 2) for t in leaf.split(H * D, -1))
        out = bsa.sparse_mha(q, k, v, layout, 32, causal=True, plain=plain)
        if not plain:
            ref = bsa.sparse_mha(q.contiguous(), k.contiguous(), v.contiguous(), layout,
                                 32, causal=True, plain=True)
            assert flash_ratio(out, ref.detach()) <= 1
        out.backward(gout)
        grads.append(leaf.grad)
    assert torch.equal(grads[0], grads[1])
    assert np.isfinite(grads[0].float().cpu().numpy()).all()


@gpu
def test_sparse_raises_instead_of_falling_back(cuda):
    import numpy as np
    from deepspeed_tpu_torch.ops import block_sparse_attention as bsa
    before = bsa.sparse_mha_fwd.launches
    q = torch.zeros(1, 2, 512, 64, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="block 256"):
        bsa.sparse_mha(q, q, q, np.ones((2, 2, 2)), 256)
    with pytest.raises(ValueError, match="D <= 256"):
        x = torch.zeros(1, 2, 512, 320, device=cuda, dtype=torch.bfloat16)
        bsa.sparse_mha(x, x, x, np.ones((2, 8, 8)), 64)
    with pytest.raises(TypeError, match="dtype"):
        x = torch.zeros(1, 2, 128, 64, device=cuda, dtype=torch.float64)
        bsa.sparse_mha(x, x, x, np.ones((2, 2, 2)), 64)
    assert bsa.sparse_mha_fwd.launches == before


# ---------------------------------------------------------------------------
# host-DRAM KV tier on the card: pinned pages, bitwise round trip
# ---------------------------------------------------------------------------

@gpu
@pytest.mark.parametrize("kv_dtype", ["fp", "int8"])
def test_host_spill_restore_is_bitwise_on_the_card(cuda, kv_dtype):
    from deepspeed_tpu_torch.inference.v2.ragged.kv_cache import BlockedKVCache
    kv = BlockedKVCache(4, 8, 64, 8, 128, dtype="bf16", kv_dtype=kv_dtype,
                        device=cuda, host_capacity=8)
    g = torch.Generator(device=cuda).manual_seed(0)
    for p in kv._pools():
        p.copy_((torch.randn(p.shape, generator=g, device=cuda) * 40).to(p.dtype))
    blocks = [1, 4, 6]
    saved = {b: [p[:, b].clone() for p in kv._pools()] for b in blocks}
    payloads = [kv.spill_block(b) for b in blocks]
    assert kv.swapper.pending == 2 and kv.swapper.landings == 1   # double buffered
    for p in kv._pools():
        p.zero_()                       # the freed ids are reused
    for payload, dst in zip(payloads, (7, 0, 2)):
        kv.restore_block(payload, dst)
        assert all(t.is_pinned() for t in payload.arrays)
    torch.cuda.synchronize()
    for b, dst in zip(blocks, (7, 0, 2)):
        for p, s in zip(kv._pools(), saved[b]):
            assert torch.equal(p[:, dst], s)
    assert kv.swapper.pending == 0 and kv.swapper.landings == 3


# ---------------------------------------------------------------------------
# tensor-parallel shares on the card: empty shares, per-rank wire frames
# ---------------------------------------------------------------------------

@gpu
def test_empty_tp_share_launches_nothing(cuda):
    """A tensor-parallel rank with no heads and no FFN columns (fewer units
    than ranks): rows 1 and 7 and the flash forward return outputs of the
    right shape, zeros where a sum of nothing is due, with no launch."""
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops import quantized_matmul as qm
    from deepspeed_tpu_torch.ops.quantizer import quantize_lastdim
    (q, k, v, bt, seen, q_len), _ = make_case(cuda, S=3, Q=2, H=8, KV=2)
    empty_q = q[:, :, :0]
    empty_pool = k[:, :0]
    before = (paged_mha.launches, dict(pa.kernel_launches()),
              qm.quantized_matmul.launches, dict(fa.kernel_launches()))
    out = paged_mha(empty_q, empty_pool, empty_pool, bt, seen, q_len)
    assert out.shape == empty_q.shape
    x = torch.randn(5, 64, device=cuda, dtype=torch.bfloat16)
    w_q, w_s = quantize_lastdim(torch.randn(64, 256, device=cuda), group_size=128)
    none = qm.quantized_matmul(x, w_q[:, :0], w_s[:, :0], 128)         # N 0
    assert none.shape == (5, 0)
    zero_k = qm.quantized_matmul(x[:, :0], w_q[:0], w_s[:0], 128)       # K 0
    assert zero_k.shape == (5, 256) and not zero_k.any()
    fq = torch.randn(2, 16, 0, 64, device=cuda, dtype=torch.bfloat16)
    assert fa.flash_mha(fq, fq, fq).shape == fq.shape
    torch.cuda.synchronize()
    after = (paged_mha.launches, dict(pa.kernel_launches()),
             qm.quantized_matmul.launches, dict(fa.kernel_launches()))
    assert after == before


@gpu
@pytest.mark.parametrize("heads", [[range(0, 8), range(8, 16)], [range(0, 1), range(0, 1)]],
                         ids=["llama_tp2", "one_kv_head_copied"])
def test_tp_rank_wire_frames_are_the_tp1_frame_heads(cuda, heads):
    """Each tp rank's bf16 wire frame of its own heads (row 5 on the card,
    one group per token row over head_dim) is, bit for bit, those heads of
    the frame of the whole pages, a copied KV head included."""
    from deepspeed_tpu_torch.inference.v2.fleet import wire
    L, n, H, bs, hd = 4, 3, 16, 64, 128
    g = torch.Generator(device=cuda).manual_seed(7)
    k = torch.randn(L, n, H, bs, hd, generator=g, device=cuda).to(torch.bfloat16)
    v = torch.randn(L, n, H, bs, hd, generator=g, device=cuda).to(torch.bfloat16)
    _, whole = wire.frame_pages(wire.encode_handle({"n": n, "k": k, "v": v, "seqs": []}))
    for hs in heads:
        hs = list(hs)
        _, mine = wire.frame_pages(wire.encode_handle(
            {"n": n, "k": k[:, :, hs].contiguous(), "v": v[:, :, hs].contiguous(),
             "seqs": []}))
        for part in ("k", "v", "ks", "vs"):
            assert np.array_equal(mine[part], whole[part][:, :, hs]), part
