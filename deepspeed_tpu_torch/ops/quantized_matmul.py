"""Fused dequantize-matmul of int8 weights (W8A16): kernel row 7.

Port of ``deepspeed_tpu/ops/pallas/quantized_matmul.py`` (``_kernel``
:55-83 under ``_quantized_matmul_local``'s ``pl.pallas_call`` at :149):
``x [M, K] @ dequant(q [K, N] int8, scale [K, N // gs] fp32)`` with groups of
``gs = min(group_size, N)`` along N (``quantize_lastdim``'s layout), the
dequantized tile rounded once to x's dtype, products accumulated in fp32 and
the result rounded once to ``out_dtype`` (x's dtype by default).

On CUDA tensors ``quantized_matmul`` launches the hand-written Hopper kernel
of ``csrc/quantized_matmul.cu`` and counts the launch in
``quantized_matmul.launches``; a shape or dtype the kernel cannot take
raises (``unsupported_reason``), it never drops to the plain version. On CPU
tensors it runs ``quantized_matmul_reference``, the plain version: the
``dense_dequant`` route's arithmetic, ``x @ dequantize_lastdim(q,
scale).to(x.dtype)`` with the products in fp32.

The kernel takes what the TPU kernel refuses: any M >= 1 (decode at batch 4)
and K % 512 != 0 (Llama's ``down_proj``, K = 11008); it needs bf16 or fp16
activations, K % 8 == 0, N % gs == 0 and gs % 16 == 0.
"""

import ctypes
import functools

import torch

from deepspeed_tpu_torch.ops.quantizer import dequantize_lastdim

BN, BK = 128, 32          # the kernel's column tile and contraction stage
_X_CODES = {torch.float16: 1, torch.bfloat16: 2}
_OUT_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}


def unsupported_reason(m, k, n, group_size, num_bits=8, dtype=torch.bfloat16,
                       out_dtype=None):
    """Why the kernel cannot take an ``[m, k] @ [k, n]`` product with these
    groups, bits and dtypes, or None when it can."""
    if num_bits != 8:
        return f"{num_bits}-bit weights have no kernel (only 8-bit does)"
    if dtype not in _X_CODES:
        return f"activations must be bf16 or fp16, got {dtype}"
    if out_dtype is not None and out_dtype not in _OUT_CODES:
        return f"out_dtype must be bf16, fp16 or fp32, got {out_dtype}"
    if m is None or k is None or n is None:
        return "no shapes provided"
    if m < 1 or k < 1 or n < 1:
        return f"empty product (M={m}, K={k}, N={n})"
    gs = min(group_size, n)
    if k % 8:
        return f"K={k} is not a multiple of 8 (16-byte rows of x)"
    if gs % 16 or n % gs:
        return (f"groups of {gs} along N={n}: N must be a multiple of the "
                f"group and the group of 16")
    return None


@functools.lru_cache(maxsize=None)
def _sm_count(device_index):
    return torch.cuda.get_device_properties(device_index).multi_processor_count


@functools.lru_cache(maxsize=None)
def plan(M, K, N, sm_count):
    """``(bm, splits, k_split)``: the row tile (16 up to M = 16, else 128)
    and, when the output tiles alone fill fewer blocks than the card has
    SMs, K split into ``splits`` ranges of ``k_split`` (a multiple of BK,
    at least 8 stages each) so that about four blocks run per SM."""
    bm = 16 if M <= 16 else 128
    tiles = -(-N // BN) * -(-M // bm)
    k_tiles = -(-K // BK)
    splits = 1
    if tiles < sm_count:
        splits = max(1, min(-(-4 * sm_count // tiles), k_tiles // 8))
    k_split = -(-k_tiles // splits) * BK
    return bm, -(-K // k_split), k_split


def quantized_matmul_reference(x, q, scale, group_size, out_dtype=None):
    """The plain version: ``x @ T(q * scale)`` with T = x's dtype, the
    products in fp32, rounded to ``out_dtype``."""
    w = dequantize_lastdim(q, scale, group_size=group_size, dtype=x.dtype)
    return (x.float() @ w.float()).to(out_dtype or x.dtype)


def _library():
    from deepspeed_tpu_torch.ops import cuda_build
    lib = cuda_build.load("quantized_matmul")
    if lib.ds_quantized_matmul.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.ds_quantized_matmul.argtypes = [p] * 5 + [i] * 9 + [p]
        lib.ds_quantized_matmul.restype = ctypes.c_int
        lib.ds_cuda_error_string.argtypes = [i]
        lib.ds_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check_cuda_args(x, q, scale, group_size, out_dtype):
    if x.device.type != "cuda":
        raise ValueError(f"quantized_matmul runs on CUDA or CPU tensors, got {x.device}")
    for name, t in (("q", q), ("scale", scale)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if x.dim() != 2 or q.dim() != 2 or q.shape[0] != x.shape[1]:
        raise ValueError(f"need x [M, K] and q [K, N], got {tuple(x.shape)}, "
                         f"{tuple(q.shape)}")
    M, K = x.shape
    N = q.shape[1]
    reason = unsupported_reason(M, K, N, group_size, 8, x.dtype, out_dtype)
    if reason:
        raise ValueError(f"quantized_matmul kernel cannot take x {tuple(x.shape)} "
                         f"{x.dtype} @ q {tuple(q.shape)} (group {group_size}): {reason}")
    gs = min(group_size, N)
    if q.dtype != torch.int8 or scale.dtype != torch.float32 or \
            tuple(scale.shape) != (K, N // gs):
        raise ValueError(f"need q int8 [K, N] and scale fp32 [K, N // {gs}], got "
                         f"{q.dtype} {tuple(q.shape)}, {scale.dtype} {tuple(scale.shape)}")
    for name, t in (("x", x), ("q", q), ("scale", scale)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    return M, K, N, gs


def quantized_matmul(x, q, scale, group_size, out_dtype=None):
    """``x [M, K] @ dequant(q [K, N], scale)`` -> ``[M, N]`` in
    ``out_dtype`` (x's dtype by default), the weight tile rounded to x's
    dtype. CUDA tensors launch the sm_90a kernel (``quantized_matmul.
    launches`` counts them) or raise; CPU tensors run the plain version."""
    if x.device.type == "cpu":
        return quantized_matmul_reference(x, q, scale, group_size, out_dtype)
    out_dtype = out_dtype or x.dtype
    M, K, N, gs = _check_cuda_args(x, q, scale, group_size, out_dtype)
    bm, splits, k_split = plan(M, K, N, _sm_count(x.device.index))
    out = torch.empty(M, N, dtype=out_dtype, device=x.device)
    work = (torch.empty(splits, M, N, dtype=torch.float32, device=x.device)
            if splits > 1 else None)
    lib = _library()
    rc = lib.ds_quantized_matmul(
        x.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(),
        None if work is None else work.data_ptr(), M, K, N, gs,
        _X_CODES[x.dtype], _OUT_CODES[out_dtype], bm, splits, k_split,
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc:
        raise RuntimeError(f"quantized_matmul kernel launch failed: "
                           f"{lib.ds_cuda_error_string(rc).decode()}")
    quantized_matmul.launches += 1
    return out


quantized_matmul.launches = 0
