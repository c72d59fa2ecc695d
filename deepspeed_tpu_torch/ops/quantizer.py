"""Groupwise symmetric integer quantization of weights (port of
``deepspeed_tpu/ops/quantizer.py``).

Two layouts, bit for bit the JAX package's:

- ``quantize`` / ``dequantize``: flat groups of ``group_size`` over the
  flattened tensor (padded with zeros to a whole group); int8 values, or at
  4 bits uint8 bytes holding two values each, element ``2j`` in the low
  nibble and ``2j + 1`` in the high one; one fp32 scale per group;
- ``quantize_lastdim`` / ``dequantize_lastdim`` (8-bit only): groups of
  ``min(group_size, d)`` along the last axis ``d`` (padded, then sliced
  back), so ``q`` keeps the tensor's shape and the scales are
  ``[..., ceil(d / gs)]``.

Scales are ``amax / qmax`` (1 for an all-zero group) and values
``clip(round_half_even(x / scale), -qmax, qmax)``, each an IEEE fp32
operation. The divisors are 0-d tensors on the data's device: PyTorch's CUDA
division by a Python scalar multiplies by the reciprocal, which is not the
IEEE quotient. This module keeps its own copy of the layouts; the ZeRO++
wire format of ``ops/quant_collective.py`` packs 4-bit groups differently.
"""

import torch

DEFAULT_GROUP = 2048


def _const(value, device):
    return torch.tensor(value, dtype=torch.float32, device=device)


def _absmax_scale(groups, qmax):
    """fp32 scales over the last axis of ``groups`` (keepdim)."""
    amax = groups.abs().amax(dim=-1, keepdim=True)
    return torch.where(amax > 0, amax / qmax, torch.ones_like(amax))


def _round_clip(groups, scale, qmax):
    q = torch.round(groups / scale)
    return torch.minimum(torch.maximum(q, -qmax), qmax).to(torch.int8)


def quantize(x, num_bits=8, group_size=DEFAULT_GROUP):
    """Symmetric groupwise quantization of any-shape ``x`` over flat groups.

    Returns ``(q, scale)``: ``q`` [groups, group_size] int8 (8-bit) or
    [groups, group_size // 2] uint8 (4-bit, two values a byte), ``scale``
    [groups] fp32. ``dequantize`` takes the original shape back."""
    if num_bits not in (8, 4):
        raise ValueError(f"unsupported bits {num_bits}")
    flat = x.reshape(-1).float()
    n = flat.numel()
    groups = max(1, -(-n // group_size))
    if groups * group_size != n:
        flat = torch.nn.functional.pad(flat, (0, groups * group_size - n))
    g = flat.reshape(groups, group_size)
    qmax = _const(127.0 if num_bits == 8 else 7.0, g.device)
    scale = _absmax_scale(g, qmax)
    q = _round_clip(g, scale, qmax)
    if num_bits == 4:
        qi = q.to(torch.int16)
        q = ((qi[:, 0::2] & 0xF) | ((qi[:, 1::2] & 0xF) << 4)).to(torch.uint8)
    return q, scale[:, 0]


def dequantize(q, scale, shape, num_bits=8, group_size=DEFAULT_GROUP,
               dtype=torch.float32):
    """Inverse of :func:`quantize` back to ``shape`` in ``dtype``."""
    if num_bits == 4:
        qi = q.to(torch.int16)
        lo, hi = qi & 0xF, (qi >> 4) & 0xF
        lo = torch.where(lo > 7, lo - 16, lo)    # sign-extend 4-bit two's complement
        hi = torch.where(hi > 7, hi - 16, hi)
        vals = torch.stack([lo, hi], dim=-1).reshape(q.shape[0], -1)
    else:
        vals = q
    out = vals.float() * scale[:, None]
    n = 1
    for d in shape:
        n *= int(d)
    return out.reshape(-1)[:n].reshape(tuple(shape)).to(dtype)


def quantize_lastdim(x, num_bits=8, group_size=256):
    """8-bit quantization in groups of ``min(group_size, d)`` along the last
    axis: ``q`` int8 of ``x``'s shape, ``scale`` fp32 ``[..., groups]``."""
    if num_bits != 8:
        raise ValueError("the lastdim layout is int8")
    d = x.shape[-1]
    gs = min(group_size, d)
    groups = -(-d // gs)
    xf = x.float()
    if groups * gs != d:
        xf = torch.nn.functional.pad(xf, (0, groups * gs - d))
    gx = xf.reshape(*xf.shape[:-1], groups, gs)
    qmax = _const(127.0, gx.device)
    scale = _absmax_scale(gx, qmax)
    q = _round_clip(gx, scale, qmax).reshape(xf.shape)[..., :d]
    return q.contiguous(), scale[..., 0]


def dequantize_lastdim(q, scale, num_bits=8, group_size=256, dtype=torch.float32):
    """``float(q) * scale`` per group along the last axis, in fp32, then
    cast to ``dtype`` (one rounding)."""
    d = q.shape[-1]
    gs = min(group_size, d)
    groups = -(-d // gs)
    qf = q.float()
    if groups * gs != d:
        qf = torch.nn.functional.pad(qf, (0, groups * gs - d))
    gq = qf.reshape(*qf.shape[:-1], groups, gs)
    out = gq * scale[..., None]
    return out.reshape(qf.shape)[..., :d].to(dtype)
