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

The source routes by the row count (``kernel_route``; ``kernel_launches``
reads the library's tally of what each call launched): up to
``DECODE_MAX_ROWS`` rows to ``decode_mma`` (mma.sync on weights dequantized
in registers), more to ``prefill_wgmma`` (wgmma on a dequantized tile).
Both take what the TPU kernel refuses: any M >= 1 (decode at batch 4) and
K % 512 != 0 (Llama's ``down_proj``, K = 11008); they need bf16 or fp16
activations, K % 8 == 0, N % gs == 0 and gs % 16 == 0.
"""

import ctypes
import functools

import torch

from deepspeed_tpu_torch.ops.quantizer import dequantize_lastdim

BN, BK = 256, 64          # the kernels' column tile and contraction stage
DECODE_MAX_ROWS = 16      # rows up to which the source routes to decode_mma
PREFILL_BM = 128          # prefill_wgmma's row tile
KERNELS = ("decode_mma", "prefill_wgmma")   # the source's enum Kernel, in order
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
    """``(kernel, splits, k_split)``: the kernel the source routes M rows to
    (a name of ``KERNELS``) and K cut into ``splits`` ranges of ``k_split``
    rows (a multiple of BK) so that the work items (row tile, BN columns, K
    range) spread evenly over the card: the fewest splits that minimise
    waves x stages per item, where a wave is one item on each of the
    kernel's resident blocks (two per SM for decode, one for prefill). A
    split's fp32 partial sums cross HBM twice, M x N x 4 bytes each way:
    cheap beside the weight at decode's few rows, not at prefill's, so
    prefill splits only a launch whose tiles leave SMs idle, into at most
    one wave of items of at least four stages each."""
    decode = M <= DECODE_MAX_ROWS
    slots = (2 if decode else 1) * sm_count
    tiles = -(-N // BN) * (1 if decode else -(-M // PREFILL_BM))
    k_stages = -(-K // BK)
    most = k_stages if decode else max(1, min(k_stages // 4, slots // tiles))
    best = None
    for s in range(1, min(most, 64) + 1):
        per = -(-k_stages // s)
        cost = -(-tiles * -(-k_stages // per) // slots) * per
        if best is None or cost < best[0]:
            best = (cost, per)
    k_split = best[1] * BK
    return KERNELS[0 if decode else 1], -(-K // k_split), k_split


def work_items(M, K, N, sm_count):
    """The kernel's work items in launch order, as ``(row0, col0, k0, k1)``:
    item i is split i // tiles and tile i % tiles, column tile by column
    tile with the row tiles of one column tile next to each other (the
    source's ``qmm_item``); each covers rows row0 .. row0 + tile rows,
    columns col0 .. col0 + BN and contraction rows k0 .. k1."""
    kernel, splits, k_split = plan(M, K, N, sm_count)
    bm = DECODE_MAX_ROWS if kernel == KERNELS[0] else PREFILL_BM
    n_mt, n_ct = -(-M // bm), -(-N // BN)
    items = []
    for i in range(n_mt * n_ct * splits):
        sp, t = divmod(i, n_mt * n_ct)
        k0 = sp * k_split
        items.append(((t % n_mt) * bm, (t // n_mt) * BN, k0, min(k0 + k_split, K)))
    return items


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
        lib.ds_quantized_matmul.argtypes = [p] * 5 + [i] * 8 + [p]
        lib.ds_quantized_matmul.restype = ctypes.c_int
        lib.ds_cuda_error_string.argtypes = [i]
        lib.ds_cuda_error_string.restype = ctypes.c_char_p
        lib.ds_qmm_route.argtypes = [i]
        lib.ds_qmm_route.restype = i
        lib.ds_qmm_kernel_launches.argtypes = [i]
        lib.ds_qmm_kernel_launches.restype = ctypes.c_longlong
    return lib


def kernel_route(M):
    """The kernel (a name of ``KERNELS``) that a product of M rows launches,
    as the kernel source decides it (``ds_qmm_route``). Builds the
    library."""
    k = _library().ds_qmm_route(M)
    if k < 0:
        raise ValueError(f"no quantized matmul kernel takes M={M} rows")
    return KERNELS[k]


def kernel_launches():
    """{kernel: launches so far} over ``KERNELS``, counted by the library
    where it launches each kernel: which kernels the calls went to."""
    lib = _library()
    return {name: lib.ds_qmm_kernel_launches(i) for i, name in enumerate(KERNELS)}


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
    launches`` counts them) or raise; CPU tensors run the plain version.
    An empty product (a tensor-parallel rank's empty share: K or N 0, or
    no rows) returns its zeros on either device without a launch."""
    if not (x.shape[0] and x.shape[1] and q.shape[1]):
        return torch.zeros(x.shape[0], q.shape[1], dtype=out_dtype or x.dtype,
                           device=x.device)
    if x.device.type == "cpu":
        return quantized_matmul_reference(x, q, scale, group_size, out_dtype)
    out_dtype = out_dtype or x.dtype
    M, K, N, gs = _check_cuda_args(x, q, scale, group_size, out_dtype)
    _, splits, k_split = plan(M, K, N, _sm_count(x.device.index))
    out = torch.empty(M, N, dtype=out_dtype, device=x.device)
    work = (torch.empty(splits, M, N, dtype=torch.float32, device=x.device)
            if splits > 1 else None)
    lib = _library()
    rc = lib.ds_quantized_matmul(
        x.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(),
        None if work is None else work.data_ptr(), M, K, N, gs,
        _X_CODES[x.dtype], _OUT_CODES[out_dtype], splits, k_split,
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc:
        raise RuntimeError(f"quantized_matmul kernel launch failed: "
                           f"{lib.ds_cuda_error_string(rc).decode()}")
    quantized_matmul.launches += 1
    return out


quantized_matmul.launches = 0
