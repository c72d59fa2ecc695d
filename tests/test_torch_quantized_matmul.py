"""Kernel row 7's plain version and the linear rows of the module registry
against the JAX package, on the CPU.

``quantized_matmul_reference`` is what ``quantized_matmul`` runs on CPU
tensors and what the kernel is held to on the card. Here it is held to the
Pallas kernel in interpret mode at ``tests/test_quantized_matmul.py``'s
shapes, in fp32: both dequantize the same ints and scales exactly and differ
only in the order of the fp32 sums, so 2e-5 (the port's fp32 parity
tolerance; outputs are of order 1). The port also takes shapes the TPU
kernel refuses (M = 4, K % 512 != 0), against ``x @ qp.dequantized()``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepspeed_tpu.inference.quantization.quantization import (
    QuantizedParameter as JaxQP)
from deepspeed_tpu.ops.pallas import quantized_matmul as jqm
from deepspeed_tpu_torch.inference.quantization import QuantizedParameter
from deepspeed_tpu_torch.inference.v2.modules import (UnsupportedModuleError,
                                                      instantiate_linear)
from deepspeed_tpu_torch.ops import quantized_matmul as qm
from deepspeed_tpu_torch.ops.quantizer import dequantize_lastdim

ATOL = 2e-5


def make_case(M=16, K=512, N=256, G=128, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(M, K)).astype(np.float32)
    w = (rng.normal(size=(K, N)) * 0.1).astype(np.float32)
    jqp = JaxQP.from_array(jnp.asarray(w), num_bits=8, group_size=G)
    qp = QuantizedParameter.from_tensor(torch.from_numpy(w), num_bits=8, group_size=G)
    assert np.array_equal(np.asarray(jqp.q), qp.q.numpy())
    assert np.array_equal(np.asarray(jqp.scale), qp.scale.numpy())
    return x, w, jqp, qp


@pytest.mark.parametrize("M,K", [(8, 512), (16, 512), (16, 1024)])
def test_plain_version_matches_pallas_interpret(M, K):
    x, _, jqp, qp = make_case(M=M, K=K, seed=K)
    want = jqm.quantized_matmul(jnp.asarray(x), jqp.q, jqp.scale, 128, interpret=True)
    got = qm.quantized_matmul(torch.from_numpy(x), qp.q, qp.scale, 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


def test_bf16_tile_is_rounded_before_the_product():
    """With bf16 activations the plain version rounds the dequantized tile
    to bf16 (the TPU kernel's ``w.astype(x.dtype)``, dense_dequant's
    ``dequantized(x.dtype)``) and then multiplies in fp32: with fp32 output
    it equals that product exactly, and differs from the unrounded tile's."""
    x, _, jqp, qp = make_case(M=8, K=1024, N=256)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = qm.quantized_matmul(xb, qp.q, qp.scale, 128, out_dtype=torch.float32)
    tile = dequantize_lastdim(qp.q, qp.scale, group_size=128)
    assert torch.equal(got, xb.float() @ tile.to(torch.bfloat16).float())
    assert not torch.equal(got, xb.float() @ tile)
    want = jnp.dot(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32),
                   jqp.dequantized(jnp.bfloat16).astype(jnp.float32),
                   precision=jax.lax.Precision.HIGHEST)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    assert torch.equal(qm.quantized_matmul(xb, qp.q, qp.scale, 128),
                       got.to(torch.bfloat16))


@pytest.mark.parametrize("M,K,N,G", [(4, 4096 + 8, 256, 128), (1, 11008 // 8, 512, 256),
                                     (13, 520, 96, 32)])
def test_shapes_the_tpu_kernel_refuses(M, K, N, G):
    x, _, jqp, qp = make_case(M=M, K=K, N=N, G=G, seed=M)
    assert not jqm.is_supported(M, K, N, G, 8)
    assert qm.unsupported_reason(M, K, N, G) is None
    got = qp.matmul(torch.from_numpy(x))
    want = jnp.asarray(x) @ jqp.dequantized(jnp.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


# -- mirrors of tests/test_module_registry.py:104-127 ------------------------

def test_linear_rows_agree():
    x, _, _, qp = make_case(M=8, K=512, N=512)
    xt = torch.from_numpy(x)
    dense = qp.matmul(xt, impl="dense_dequant")
    fused = qp.matmul(xt, impl="cuda_fused_dequant")
    auto = qp.matmul(xt)
    np.testing.assert_allclose(fused.numpy(), dense.numpy(), rtol=0, atol=ATOL)
    assert torch.equal(auto, fused)
    assert instantiate_linear(8, 512, 512, 128, 8)[0] == "cuda_fused_dequant"
    for bits in (4, 6, 12):
        assert instantiate_linear(8, 512, 512, 128, bits)[0] == "dense_dequant"


def test_bad_pin_raises():
    w = torch.from_numpy(np.random.default_rng(0).normal(size=(100, 60)).astype(np.float32))
    qp = QuantizedParameter.from_tensor(w, num_bits=8, group_size=20)
    x = torch.ones(4, 100)
    with pytest.raises(UnsupportedModuleError, match="K=100"):
        qp.matmul(x, impl="cuda_fused_dequant")
    with pytest.raises(UnsupportedModuleError, match="K=100"):
        qp.matmul(x)                      # auto is the kernel row at 8 bits
    assert qp.matmul(x, impl="dense_dequant").shape == (4, 60)
    q4 = QuantizedParameter.from_tensor(w, num_bits=4, group_size=20)
    with pytest.raises(UnsupportedModuleError, match="4-bit"):
        q4.matmul(x, impl="cuda_fused_dequant")
    assert q4.matmul(x).shape == (4, 60)


def test_unsupported_reason():
    ok = dict(m=4, k=4096, n=11008, group_size=256)
    assert qm.unsupported_reason(**ok) is None
    assert "4-bit" in qm.unsupported_reason(**ok, num_bits=4)
    assert "bf16 or fp16" in qm.unsupported_reason(**ok, dtype=torch.float32)
    assert "out_dtype" in qm.unsupported_reason(**ok, out_dtype=torch.int8)
    assert "K=4100" in qm.unsupported_reason(**dict(ok, k=4100))
    assert "N=11000" in qm.unsupported_reason(**dict(ok, n=11000))
    assert "group" in qm.unsupported_reason(**dict(ok, n=11008 + 8, group_size=8))
    assert "empty" in qm.unsupported_reason(**dict(ok, m=0))


@pytest.mark.parametrize("M,K,N", [(4, 4096, 11008), (4, 11008, 4096), (1, 4096, 4096),
                                   (1024, 4096, 11008), (1024, 4096, 4096), (13, 64, 32)])
def test_split_plan_covers_k(M, K, N):
    """Every K element falls in exactly one split, each split a whole number
    of 64-row stages and none empty; up to 16 rows go to the decode kernel
    and split K to spread over the card's 2 x 132 resident blocks, a prefill
    whose tiles fill more than half of the 132 SMs does not split."""
    kernel, splits, k_split = qm.plan(M, K, N, 132)
    assert kernel == ("decode_mma" if M <= 16 else "prefill_wgmma")
    assert k_split % qm.BK == 0 and (splits - 1) * k_split < K <= splits * k_split
    tiles = -(-N // qm.BN) * (1 if M <= 16 else -(-M // qm.PREFILL_BM))
    slots = 2 * 132 if M <= 16 else 132
    if M > 16 and 2 * tiles > slots:
        assert splits == 1
    elif K >= 8 * qm.BK and 2 * tiles <= slots:
        assert splits > 1
    # the items fill whole waves of the resident blocks to within one stage
    # of the work spread evenly
    stages = -(-k_split // qm.BK)
    waves = -(-tiles * splits // slots)
    assert waves * stages <= -(-tiles * -(-K // qm.BK) // slots) + stages


@pytest.mark.parametrize("M,K,N", [(4, 4096, 11008), (13, 1032, 528), (17, 1032, 528),
                                   (300, 4096, 1024), (1024, 11008, 4096), (1, 64, 16)])
def test_work_items_cover_every_output_and_k_once(M, K, N):
    """The kernel's work items (``work_items``, the source's ``qmm_item``
    order) cover every (row, column, contraction row) exactly once: each
    (row tile, column tile) once per split, the splits' K ranges tiling
    [0, K)."""
    kernel, splits, k_split = qm.plan(M, K, N, 132)
    items = qm.work_items(M, K, N, 132)
    bm = qm.DECODE_MAX_ROWS if kernel == "decode_mma" else qm.PREFILL_BM
    tiles = {(r, c) for r in range(0, M, bm) for c in range(0, N, qm.BN)}
    assert len(items) == len(tiles) * splits == len(set(items))
    for tile in tiles:
        ranges = sorted((k0, k1) for r, c, k0, k1 in items if (r, c) == tile)
        assert ranges[0][0] == 0 and ranges[-1][1] == K
        assert all(a[1] == b[0] and a[0] < a[1] for a, b in zip(ranges, ranges[1:]))
    # concurrent items (one split at a time) share the K range
    assert [k0 for _, _, k0, _ in items] == sorted(k0 for _, _, k0, _ in items)
