"""FP6 / FP12 groupwise float quantization (port of
``deepspeed_tpu/ops/fp_quantizer.py``).

Formats: fp6 = e3m2 (bias 3), fp12 = e5m6 (bias 15), with no inf or NaN
codes. ``quantize_fp`` scales each flat group of ``group_size`` by
``amax / max_representable``, rounds the fp32 mantissa to nearest-even in
bit space (a carry may bump the exponent), clamps overflow to the largest
code, flushes underflow and denormals to a signed zero, and packs the codes
LSB first: four 6-bit codes or two 12-bit codes per 3 bytes. The integer
bit math runs on ``int32`` views (``>>`` is arithmetic, as in JAX), and the
packed bytes are bit for bit the JAX package's.
"""

import torch

DEFAULT_GROUP = 2048

FORMATS = {6: (3, 2, 3), 12: (5, 6, 15)}  # bits -> (e_bits, m_bits, bias)


def max_representable(e_bits, m_bits, bias):
    emax = (1 << e_bits) - 1 - bias  # top exponent (no inf/nan codes)
    return float(2.0 ** emax * (2.0 - 2.0 ** -m_bits))


def encode(y, e_bits, m_bits, bias):
    """fp32 values (already scaled) -> small-float codes, int32, same shape."""
    y = y.float()
    b = y.view(torch.int32)
    sign = (b >> 31) & 1
    exp = ((b >> 23) & 0xFF) - 127           # unbiased fp32 exponent
    man = b & 0x7FFFFF
    shift = 23 - m_bits
    lsb = (man >> shift) & 1                 # round to nearest even
    man_r = (man + ((1 << (shift - 1)) - 1) + lsb) >> shift
    carry = man_r >> m_bits
    man_r = man_r & ((1 << m_bits) - 1)
    qexp = exp + carry + bias
    max_exp = (1 << e_bits) - 1
    sign_bit = sign << (e_bits + m_bits)
    code = sign_bit | (qexp.clamp(1, max_exp) << m_bits) | man_r
    code = torch.where(qexp > max_exp,
                       sign_bit | (max_exp << m_bits) | ((1 << m_bits) - 1), code)
    code = torch.where(qexp < 1, sign_bit, code)   # underflow / denormal -> +-0
    return torch.where(y == 0.0, torch.zeros_like(code), code)


def decode(code, e_bits, m_bits, bias):
    code = code.to(torch.int32)
    sign = (code >> (e_bits + m_bits)) & 1
    exp = (code >> m_bits) & ((1 << e_bits) - 1)
    man = code & ((1 << m_bits) - 1)
    bits = (sign << 31) | ((exp - bias + 127) << 23) | (man << (23 - m_bits))
    val = bits.view(torch.float32)
    zero = torch.where(sign == 1, torch.full_like(val, -0.0), torch.zeros_like(val))
    return torch.where(exp == 0, zero, val)


def pack_codes(codes, bits):
    """Flat codes -> uint8 bytes, LSB-first, zero codes padding the last unit
    (4 values per 3 bytes at fp6, 2 per 3 at fp12)."""
    per = 4 if bits == 6 else 2
    c = codes.reshape(-1).to(torch.int64)
    if c.numel() % per:
        c = torch.nn.functional.pad(c, (0, per - c.numel() % per))
    c = c.reshape(-1, per)
    if bits == 6:
        word = c[:, 0] | (c[:, 1] << 6) | (c[:, 2] << 12) | (c[:, 3] << 18)
    else:
        word = c[:, 0] | (c[:, 1] << 12)
    out = torch.stack([word & 0xFF, (word >> 8) & 0xFF, (word >> 16) & 0xFF], dim=1)
    return out.reshape(-1).to(torch.uint8)


def unpack_codes(packed, n, bits):
    by = packed.to(torch.int64).reshape(-1, 3)
    word = by[:, 0] | (by[:, 1] << 8) | (by[:, 2] << 16)
    if bits == 6:
        c = torch.stack([word & 0x3F, (word >> 6) & 0x3F, (word >> 12) & 0x3F,
                         (word >> 18) & 0x3F], dim=1)
    else:
        c = torch.stack([word & 0xFFF, (word >> 12) & 0xFFF], dim=1)
    return c.reshape(-1)[:n].to(torch.int32)


def quantize_fp(x, bits=6, group_size=DEFAULT_GROUP):
    """Groupwise FP quantization: (packed uint8, fp32 scale per group)."""
    if bits not in FORMATS:
        raise ValueError(f"fp quantizer supports bits in {tuple(FORMATS)}, got {bits}")
    e_bits, m_bits, bias = FORMATS[bits]
    flat = x.reshape(-1).float()
    n = flat.numel()
    groups = max(1, -(-n // group_size))
    if groups * group_size != n:
        flat = torch.nn.functional.pad(flat, (0, groups * group_size - n))
    g = flat.reshape(groups, group_size)
    amax = g.abs().amax(dim=1, keepdim=True)
    top = torch.tensor(max_representable(e_bits, m_bits, bias), dtype=torch.float32,
                       device=g.device)
    scale = torch.where(amax > 0, amax / top, torch.ones_like(amax))
    codes = encode(g / scale, e_bits, m_bits, bias)
    return pack_codes(codes, bits), scale[:, 0]


def dequantize_fp(packed, scale, shape, bits=6, group_size=DEFAULT_GROUP,
                  dtype=torch.float32):
    e_bits, m_bits, bias = FORMATS[bits]
    n = 1
    for d in shape:
        n *= int(d)
    groups = scale.shape[0]
    codes = unpack_codes(packed, groups * group_size, bits)
    vals = decode(codes, e_bits, m_bits, bias).reshape(groups, -1)
    out = vals * scale[:, None]
    return out.reshape(-1)[:n].reshape(tuple(shape)).to(dtype)
