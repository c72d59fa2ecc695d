"""The port's weight quantizers against the JAX package's, on the CPU.

``ops/quantizer.py`` (flat int8/int4 groups, the lastdim layout) and
``ops/fp_quantizer.py`` (fp6 e3m2, fp12 e5m6) must give the JAX functions'
codes, packed bytes and scales bit for bit on the same numpy inputs: every
step is an IEEE fp32 operation or integer bit math. The remaining cases
mirror ``tests/test_fp_quantizer.py`` inside the port.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deepspeed_tpu.ops import fp_quantizer as jfp
from deepspeed_tpu.ops import quantizer as jq
from deepspeed_tpu_torch.inference.quantization import QuantizedParameter
from deepspeed_tpu_torch.ops import fp_quantizer as fp
from deepspeed_tpu_torch.ops import quantizer as q8


def weights(shape=(37, 300), seed=0):
    """Rows of very different magnitudes, an all-zero row and a few zeros."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=shape) * rng.lognormal(size=(shape[0], 1))).astype(np.float32)
    x[0, :5] = 0.0
    x[3] = 0.0
    return x


def same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype == np.float32:
        a, b = a.view(np.int32), b.view(np.int32)
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("group", [64, 100, 2048])
def test_flat_groups_match_jax(bits, group):
    x = weights()
    qj, sj = jq.quantize(jnp.asarray(x), bits, group)
    qt, st = q8.quantize(torch.from_numpy(x), bits, group)
    assert same(qj, qt.numpy()) and same(sj, st.numpy())
    dj = jq.dequantize(qj, sj, x.shape, bits, group)
    dt = q8.dequantize(qt, st, x.shape, bits, group)
    assert same(dj, dt.numpy())


@pytest.mark.parametrize("group", [64, 256, 70, 512])   # 70: d % G != 0; 512: d < G
def test_lastdim_matches_jax(group):
    x = weights()
    qj, sj = jq.quantize_lastdim(jnp.asarray(x), group_size=group)
    qt, st = q8.quantize_lastdim(torch.from_numpy(x), group_size=group)
    assert same(qj, qt.numpy()) and same(sj, st.numpy())
    assert qt.shape == x.shape and st.shape == (x.shape[0], -(-300 // min(group, 300)))
    dj = jq.dequantize_lastdim(qj, sj, group_size=group)
    dt = q8.dequantize_lastdim(qt, st, group_size=group)
    assert same(dj, dt.numpy())


def test_lastdim_stacked_leaf_matches_jax():
    """A scan-stacked [L, K, N] leaf, as the JAX engine quantizes it."""
    x = weights((3 * 16, 96)).reshape(3, 16, 96)
    qj, sj = jq.quantize_lastdim(jnp.asarray(x), group_size=32)
    qt, st = q8.quantize_lastdim(torch.from_numpy(x), group_size=32)
    assert same(qj, qt.numpy()) and same(sj, st.numpy())


@pytest.mark.parametrize("bits", [6, 12])
@pytest.mark.parametrize("group", [64, 512, 1000])
def test_fp_matches_jax(bits, group):
    x = weights()
    pj, sj = jfp.quantize_fp(jnp.asarray(x), bits, group)
    pt, st = fp.quantize_fp(torch.from_numpy(x), bits, group)
    assert same(pj, pt.numpy()) and same(sj, st.numpy())
    dj = jfp.dequantize_fp(pj, sj, x.shape, bits, group)
    dt = fp.dequantize_fp(pt, st, x.shape, bits, group)
    assert same(dj, dt.numpy())


@pytest.mark.parametrize("bits", [6, 12])
def test_fp_codes_match_jax_at_the_edges(bits):
    """Rounding carries, overflow, underflow, signed zeros, exact values."""
    y = np.array([1e6, -1e6, 1e-6, -1e-6, 0.0, -0.0, 3.3, 28.0, 29.0, 1.875, 1.9375,
                  0.0625, -0.03, 15.99, 65504.0], np.float32)
    e, m, b = jfp._FORMATS[bits]
    cj = jfp._encode(jnp.asarray(y), e, m, b)
    ct = fp.encode(torch.from_numpy(y), e, m, b)
    assert same(cj, ct.numpy())
    assert same(jfp._decode(cj, e, m, b), fp.decode(ct, e, m, b).numpy())


# -- mirrors of tests/test_fp_quantizer.py -----------------------------------

@pytest.mark.parametrize("bits", [6, 12])
def test_roundtrip_error_bounded(bits):
    x = torch.from_numpy(np.random.default_rng(0).normal(size=4096).astype(np.float32) * 0.05)
    packed, scale = fp.quantize_fp(x, bits=bits, group_size=512)
    back = fp.dequantize_fp(packed, scale, x.shape, bits=bits, group_size=512)
    rel = (back - x).abs() / (x.abs() + 1e-6)
    # e3m2: 2 mantissa bits, <= 12.5% steps; e5m6 <= 0.8%
    assert rel.median() < (0.09 if bits == 6 else 0.006)


def test_packed_size_is_true_bitwidth():
    x = torch.ones(4096)
    p6, _ = fp.quantize_fp(x, bits=6, group_size=4096)
    p12, _ = fp.quantize_fp(x, bits=12, group_size=4096)
    assert p6.numel() == 4096 * 6 // 8 and p6.dtype == torch.uint8
    assert p12.numel() == 4096 * 12 // 8


def test_exact_values_roundtrip():
    vals = torch.tensor([0.0, 1.0, -1.0, 1.5, 0.75, -0.375, 12.0, -14.0])
    e, m, b = fp.FORMATS[6]
    assert torch.equal(fp.decode(fp.encode(vals, e, m, b), e, m, b), vals)


def test_overflow_clamps_underflow_flushes():
    e, m, b = fp.FORMATS[6]
    big = fp.decode(fp.encode(torch.tensor([1e6]), e, m, b), e, m, b)
    assert float(big[0]) == 28.0       # e3m2 max: 2^4 * 1.75
    tiny = fp.decode(fp.encode(torch.tensor([1e-6]), e, m, b), e, m, b)
    assert float(tiny[0]) == 0.0


def test_fp6_beats_int4_on_gaussian_weights():
    x = torch.from_numpy(np.random.default_rng(1).normal(size=8192).astype(np.float32))
    p, s = fp.quantize_fp(x, bits=6, group_size=1024)
    fp6 = fp.dequantize_fp(p, s, x.shape, bits=6, group_size=1024)
    q, qs = q8.quantize(x, num_bits=4, group_size=1024)
    i4 = q8.dequantize(q, qs, x.shape, num_bits=4, group_size=1024)
    assert ((fp6 - x) ** 2).mean() < ((i4 - x) ** 2).mean()


def test_quantized_parameter_fp6_serving():
    w = torch.from_numpy(np.random.default_rng(2).normal(size=(128, 64)).astype(np.float32)
                         * 0.1)
    qp = QuantizedParameter.from_tensor(w, num_bits=6, group_size=512)
    assert qp.nbytes < w.numel() * 4 / 4
    back = qp.dequantized(dtype=torch.float32)
    assert ((back - w).abs() / (w.abs() + 1e-6)).median() < 0.09


def test_bad_bits_raise():
    with pytest.raises(ValueError):
        q8.quantize(torch.ones(8), num_bits=3)
    with pytest.raises(ValueError):
        q8.quantize_lastdim(torch.ones(8), num_bits=4)
    with pytest.raises(ValueError):
        fp.quantize_fp(torch.ones(8), bits=5)
