"""The port's CUDA kernels against their plain PyTorch versions, on the GPU.

The tests marked ``gpu`` need a CUDA device: the hand-written kernels have
no CPU mode, so on a host without one they skip with that reason. The one
unmarked test checks the comparison's bound with the plain version alone.
This file imports neither JAX nor the JAX package, so it also runs where
only PyTorch is installed: ``python -m pytest tests/test_torch_gpu_kernels.py
--noconftest``.

Tolerance, per element: |kernel - plain| <= ATOL + RTOL * |plain|. Kernel
and plain version both compute in fp32 from the same inputs and differ only
in summation order before the final rounding to the output dtype, which
moves a value by at most one unit in its last place: 2^-7 of it in bf16,
2^-10 in fp16; fp32 outputs are not rounded again. ATOL covers the fp32
summation-order noise of elements near 0. A one-page fault exceeds the bound
by two orders of magnitude (``test_bound_rejects_one_page_fault``).
"""

import pytest
import torch

from deepspeed_tpu_torch.ops.paged_attention import paged_mha, paged_mha_reference

gpu = pytest.mark.gpu

ATOL = 2e-5
RTOL = {torch.bfloat16: 2 ** -7, torch.float16: 2 ** -10, torch.float32: 2 ** -16}


def err_ratio(out, ref):
    """Largest |out - ref| / (ATOL + RTOL * |ref|): at most 1 passes."""
    bound = ATOL + RTOL[ref.dtype] * ref.float().abs()
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


@gpu
@pytest.mark.parametrize("Q", [1, 8, 33])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("H,KV", [(8, 2), (4, 4)], ids=["gqa", "mha"])
def test_kernel_matches_plain(cuda, Q, dtype, H, KV):
    args, kw = make_case(cuda, Q=Q, H=H, KV=KV, dtype=dtype, seed=Q)
    before = paged_mha.launches
    out = paged_mha(*args, **kw)
    assert paged_mha.launches == before + 1
    ref = paged_mha_reference(*args, **kw)
    torch.cuda.synchronize()
    assert err_ratio(out, ref) <= 1


@gpu
@pytest.mark.parametrize("window", [5, 40])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("Dh", [16, 128, 256])
def test_kernel_window_int8_head_dims(cuda, window, int8, Dh):
    args, kw = make_case(cuda, Q=8, Dh=Dh, int8=int8, seed=Dh)
    out = paged_mha(*args, window=window, **kw)
    ref = paged_mha_reference(*args, window=window, **kw)
    torch.cuda.synchronize()
    assert err_ratio(out, ref) <= 1


@gpu
def test_kernel_zero_rows(cuda):
    args, kw = make_case(cuda, S=4, Q=8, q_len=[8, 0, 3, 1])
    out = paged_mha(*args, **kw)
    torch.cuda.synchronize()
    assert not out[1].any() and not out[2, 3:].any() and not out[3, 1:].any()
    ref = paged_mha_reference(*args, **kw)
    assert err_ratio(out, ref) <= 1


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
