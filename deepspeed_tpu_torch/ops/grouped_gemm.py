"""Ragged grouped-GEMM MoE expert FFN, forward and backward.

Port of ``deepspeed_tpu/ops/pallas/grouped_gemm.py`` (``topk_router``,
``moe_ffn_gmm`` / ``_moe_ffn_gmm_local`` and ``moe_ffn_gmm_rows``, whose
three megablox ``gmm`` calls each reach ``pl.pallas_call``) and of megablox's custom-VJP backward of each call
(``megablox/ops.py`` ``_gmm_bwd``: ``gmm(..., transpose_rhs=True)`` for dx,
``tgmm`` for dW), which the JAX training path runs under ``jax.grad``.
``grouped_matmul`` launches the hand-written Hopper kernel
``csrc/grouped_gemm.cu`` on CUDA tensors and counts each launch in
``grouped_matmul.launches``; when autograd records it, its backward launches
``grouped_matmul_dx`` and ``grouped_matmul_dw`` (each with its own
``.launches``). On CPU tensors each runs its plain PyTorch version
(``*_reference``). A CUDA tensor never reaches a plain version through these
wrappers: what the kernels cannot take raises.

The kernel source chooses each call's kernel (``kernel_route`` reads the
choice, ``kernel_launches`` counts what each call launched): bf16/fp16
forward and dx run the ``wgmma`` kernel fed by TMA at every row count, bf16
dW its ``wgmma`` counterpart (the rows contracted, both operands read
MN-major); fp32 runs SIMT kernels.

Layouts (the JAX package's): x [T, D]; w1/w3 [E, D, F]; w2 [E, F, D]; the
router weight [D, E]; top_vals fp32 [T, k]; top_idx int [T, k]. A grouped
product takes rows ``xs [R, K]`` sorted by expert and ``group_offsets [E+1]``
int32 (``group_offsets[e]:group_offsets[e+1]`` are expert ``e``'s rows,
``group_offsets[0] == 0``, ``group_offsets[E] == R``), and returns
``xs[rows_e] @ w[e]`` for every expert, accumulated in fp32 and rounded once
to xs's dtype: megablox ``gmm(..., preferred_element_type=float32)`` followed
by ``.astype(dtype)``. Its backward takes the output gradient ``dy [R, N]``
in the same dtype: ``dx = dy[rows_e] @ w[e]^T`` rounded to xs's dtype, and
``dW[e] = xs[rows_e]^T @ dy[rows_e]`` rounded to w's dtype, zero for an
expert with no rows. The backward takes bf16 and fp32, as megablox does: an
fp16 product under autograd raises its ``ValueError``.

The JAX wrapper pads the rows to its 128-row tile into the last group; the
kernels mask their ragged row, K and N edges themselves, so nothing is
padded. Group sizes and offsets are computed on the device: the kernels
find each tile's expert from ``group_offsets`` themselves, so neither a
forward nor a backward costs a host sync. Rows past ``group_offsets[E]``
belong to no expert: the kernels skip them (their output rows are left
unwritten), which ``moe_ffn_gmm_rows`` uses for the sentinel rows of the
expert-parallel receive buffer.
"""

import ctypes

import torch
import torch.nn.functional as F

_DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
# 16-byte loads of K- and N-contiguous rows: both widths must be multiples of
# 8 elements (16 bytes of bf16/fp16)
ALIGN = 8


def unsupported_reason(k_dim, n_dim):
    """Why the kernel cannot take a [R, K] @ [E, K, N] product, or None."""
    for name, v in (("K", k_dim), ("N", n_dim)):
        if v is None or v < 1 or v % ALIGN:
            return f"{name}={v} is not a positive multiple of {ALIGN}"
    return None


def is_supported(d_model, d_ff):
    """Whether the kernel takes both products of the expert FFN: x @ w1/w3
    contracts D and emits F, h @ w2 contracts F and emits D."""
    return unsupported_reason(d_model, d_ff) is None


def topk_router(x, gate_wg, k):
    """Mixtral top-k softmax router with renormalised gate weights.

    The routing of both dispatch paths: ``(x @ gate_wg)`` in x's dtype, then
    fp32, softmax, top-k, renormalise. Ties go to the lower expert index, as
    ``jax.lax.top_k`` does: a stable sort of the negated probabilities keeps
    equal values in index order, which ``torch.topk`` does not promise.
    Returns (top_vals fp32 [T, k], top_idx int64 [T, k])."""
    probs = torch.softmax((x @ gate_wg).float(), dim=-1)
    top_idx = torch.sort(-probs, dim=-1, stable=True).indices[:, :k]
    top_vals = torch.gather(probs, 1, top_idx)
    return top_vals / top_vals.sum(-1, keepdim=True), top_idx


def grouped_matmul_reference(xs, w, group_offsets):
    """Plain PyTorch version of the kernel: a loop over experts of
    ``xs[rows_e].float() @ w[e].float()``, cast once to xs's dtype. Reads the
    offsets on the host (one sync), which the kernel never does."""
    offs = group_offsets.tolist()
    out = torch.empty(xs.shape[0], w.shape[2], dtype=xs.dtype, device=xs.device)
    for e in range(w.shape[0]):
        lo, hi = offs[e], offs[e + 1]
        if hi > lo:
            out[lo:hi] = (xs[lo:hi].float() @ w[e].float()).to(xs.dtype)
    return out


def grouped_matmul_dx_reference(dy, w, group_offsets):
    """Plain PyTorch version of the dx kernel (megablox ``gmm(dy, w,
    transpose_rhs=True)``): ``dy[rows_e].float() @ w[e].float().T`` for
    every expert, cast once to dy's dtype. dy [R, N], w [E, K, N] -> [R, K].
    Reads the offsets on the host."""
    offs = group_offsets.tolist()
    out = torch.empty(dy.shape[0], w.shape[1], dtype=dy.dtype, device=dy.device)
    for e in range(w.shape[0]):
        lo, hi = offs[e], offs[e + 1]
        if hi > lo:
            out[lo:hi] = (dy[lo:hi].float() @ w[e].float().T).to(dy.dtype)
    return out


def grouped_matmul_dw_reference(xs, dy, group_offsets):
    """Plain PyTorch version of the dW kernel (megablox ``tgmm``):
    ``xs[rows_e].float().T @ dy[rows_e].float()`` for every expert, zero for
    an expert with no rows, cast once to xs's dtype. xs [R, K], dy [R, N] ->
    [E, K, N] with E = len(group_offsets) - 1. Reads the offsets on the
    host."""
    offs = group_offsets.tolist()
    E = len(offs) - 1
    out = torch.zeros(E, xs.shape[1], dy.shape[1], dtype=xs.dtype, device=xs.device)
    for e in range(E):
        lo, hi = offs[e], offs[e + 1]
        if hi > lo:
            out[e] = (xs[lo:hi].float().T @ dy[lo:hi].float()).to(xs.dtype)
    return out


def _library():
    from deepspeed_tpu_torch.ops import cuda_build
    lib = cuda_build.load("grouped_gemm")
    if lib.ds_grouped_matmul.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.ds_grouped_matmul, lib.ds_grouped_matmul_dx,
                   lib.ds_grouped_matmul_dw):
            fn.argtypes = [p] * 4 + [i] * 5 + [p]
            fn.restype = ctypes.c_int
        lib.ds_cuda_error_string.argtypes = [i]
        lib.ds_cuda_error_string.restype = ctypes.c_char_p
        lib.ds_grouped_route.argtypes = [i] * 2
        lib.ds_grouped_route.restype = i
        lib.ds_grouped_kernel_launches.argtypes = [i]
        lib.ds_grouped_kernel_launches.restype = ctypes.c_longlong
    return lib


# The kernels in the order of the source's launch tally (enum Kernel).
KERNELS = ("fwd_simt", "fwd_wgmma", "dx_simt", "dx_wgmma", "dw_simt", "dw_wgmma")
_WHICH = {"fwd": 0, "dx": 1, "dw": 2}


def kernel_route(which, dtype):
    """The kernel (a name of ``KERNELS``) that ``which`` (``"fwd"``,
    ``"dx"`` or ``"dw"``) launches for inputs of ``dtype``, as the kernel
    source decides it (``ds_grouped_route``). Builds the library."""
    k = _library().ds_grouped_route(_WHICH[which], _DTYPE_CODES[dtype])
    if k < 0:
        raise ValueError(f"no grouped GEMM kernel takes {which} in {dtype}")
    return KERNELS[k]


def kernel_launches():
    """{kernel: launches so far} over ``KERNELS``, counted by the library
    where it launches each kernel: which kernels the calls went to."""
    lib = _library()
    return {name: lib.ds_grouped_kernel_launches(i) for i, name in enumerate(KERNELS)}


def _check_common(a, b, group_offsets, names, dtypes):
    for name, t in ((names[1], b), ("group_offsets", group_offsets)):
        if t.device != a.device:
            raise ValueError(f"{name} is on {t.device}, {names[0]} on {a.device}")
    for name, t in ((names[0], a), (names[1], b), ("group_offsets", group_offsets)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if a.dtype not in dtypes:
        raise TypeError(f"{names[0]} dtype {a.dtype} not in {list(dtypes)}")
    if b.dtype != a.dtype:
        raise TypeError(f"{names[1]} dtype {b.dtype} != {names[0]} dtype {a.dtype}")
    for name, t in ((names[0], a), (names[1], b)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def _check_offsets(group_offsets, E):
    if group_offsets.dtype != torch.int32 or tuple(group_offsets.shape) != (E + 1,):
        raise ValueError(f"group_offsets must be int32 [E+1={E + 1}], got "
                         f"{group_offsets.dtype} {tuple(group_offsets.shape)}")


def _check_cuda_args(xs, w, group_offsets):
    _check_common(xs, w, group_offsets, ("xs", "w"), _DTYPE_CODES)
    if xs.dim() != 2 or w.dim() != 3 or w.shape[1] != xs.shape[1]:
        raise ValueError(f"need xs [R, K] and w [E, K, N], got "
                         f"{tuple(xs.shape)}, {tuple(w.shape)}")
    _check_offsets(group_offsets, w.shape[0])
    reason = unsupported_reason(w.shape[1], w.shape[2])
    if reason:
        raise ValueError(f"grouped_matmul kernel cannot take these shapes: "
                         f"{reason}")


# the backward kernels take megablox's dtypes (common.py
# assert_is_supported_dtype): bf16 on the tensor cores, fp32 on CUDA cores
_BWD_DTYPES = {torch.float32: 0, torch.bfloat16: 2}


def _check_backward_dtype(dtype):
    if dtype not in _BWD_DTYPES:
        raise ValueError(f"the grouped GEMM backward (megablox gmm/tgmm) "
                         f"expected a bfloat16 or float32 array but got {dtype}")


def _launch(fn, name, a, b, group_offsets, out, R, K, N, E, dtype_code):
    rc = fn(a.data_ptr(), b.data_ptr(), group_offsets.data_ptr(), out.data_ptr(),
            R, K, N, E, dtype_code,
            torch.cuda.current_stream(a.device).cuda_stream)
    if rc:
        lib = _library()
        raise RuntimeError(f"{name} kernel launch failed: "
                           f"{lib.ds_cuda_error_string(rc).decode()}")


def _cuda_device_or_raise(name, t):
    if t.device.type != "cuda":
        raise ValueError(f"{name} runs on CUDA or CPU tensors, got {t.device}")


def _grouped_matmul_forward(xs, w, group_offsets):
    if xs.device.type == "cpu":
        return grouped_matmul_reference(xs, w, group_offsets)
    _cuda_device_or_raise("grouped_matmul", xs)
    _check_cuda_args(xs, w, group_offsets)
    R, K = xs.shape
    E, _, N = w.shape
    out = torch.empty(R, N, dtype=xs.dtype, device=xs.device)
    if R == 0:
        return out
    _launch(_library().ds_grouped_matmul, "grouped_matmul", xs, w, group_offsets,
            out, R, K, N, E, _DTYPE_CODES[xs.dtype])
    grouped_matmul.launches += 1
    return out


def grouped_matmul_dx(dy, w, group_offsets):
    """dx of the grouped product: ``dx[r] = dy[r] @ w[e(r)]^T`` for rows
    sorted by expert, fp32 accumulation rounded once to dy's dtype (megablox
    ``gmm(dy, w, transpose_rhs=True)``). dy [R, N], w [E, K, N] -> [R, K].

    CUDA tensors launch the sm_90a kernel (``grouped_matmul_dx.launches``
    counts each launch); CPU tensors run ``grouped_matmul_dx_reference``."""
    if dy.device.type == "cpu":
        return grouped_matmul_dx_reference(dy, w, group_offsets)
    _cuda_device_or_raise("grouped_matmul_dx", dy)
    _check_backward_dtype(dy.dtype)
    _check_common(dy, w, group_offsets, ("dy", "w"), _BWD_DTYPES)
    if dy.dim() != 2 or w.dim() != 3 or w.shape[2] != dy.shape[1]:
        raise ValueError(f"need dy [R, N] and w [E, K, N], got "
                         f"{tuple(dy.shape)}, {tuple(w.shape)}")
    _check_offsets(group_offsets, w.shape[0])
    reason = unsupported_reason(w.shape[1], w.shape[2])
    if reason:
        raise ValueError(f"grouped_matmul_dx kernel cannot take these shapes: "
                         f"{reason}")
    R, N = dy.shape
    E, K, _ = w.shape
    out = torch.empty(R, K, dtype=dy.dtype, device=dy.device)
    if R == 0:
        return out
    _launch(_library().ds_grouped_matmul_dx, "grouped_matmul_dx", dy, w,
            group_offsets, out, R, K, N, E, _BWD_DTYPES[dy.dtype])
    grouped_matmul_dx.launches += 1
    return out


def grouped_matmul_dw(xs, dy, group_offsets):
    """dW of the grouped product: ``dW[e] = xs[rows_e]^T @ dy[rows_e]``,
    zero for an expert with no rows, fp32 accumulation rounded once to xs's
    dtype (megablox ``tgmm``). xs [R, K], dy [R, N] -> [E, K, N] with
    E = len(group_offsets) - 1.

    CUDA tensors launch the sm_90a kernel (``grouped_matmul_dw.launches``
    counts each launch); CPU tensors run ``grouped_matmul_dw_reference``."""
    if xs.device.type == "cpu":
        return grouped_matmul_dw_reference(xs, dy, group_offsets)
    _cuda_device_or_raise("grouped_matmul_dw", xs)
    _check_backward_dtype(xs.dtype)
    _check_common(xs, dy, group_offsets, ("xs", "dy"), _BWD_DTYPES)
    if xs.dim() != 2 or dy.dim() != 2 or dy.shape[0] != xs.shape[0]:
        raise ValueError(f"need xs [R, K] and dy [R, N], got "
                         f"{tuple(xs.shape)}, {tuple(dy.shape)}")
    if group_offsets.dim() != 1 or group_offsets.numel() < 2:
        raise ValueError(f"group_offsets must be int32 [E+1], got "
                         f"{tuple(group_offsets.shape)}")
    E = group_offsets.numel() - 1
    _check_offsets(group_offsets, E)
    reason = unsupported_reason(xs.shape[1], dy.shape[1])
    if reason:
        raise ValueError(f"grouped_matmul_dw kernel cannot take these shapes: "
                         f"{reason}")
    R, K = xs.shape
    N = dy.shape[1]
    if R == 0 or E == 0:
        return torch.zeros(E, K, N, dtype=xs.dtype, device=xs.device)
    out = torch.empty(E, K, N, dtype=xs.dtype, device=xs.device)
    _launch(_library().ds_grouped_matmul_dw, "grouped_matmul_dw", xs, dy,
            group_offsets, out, R, K, N, E, _BWD_DTYPES[xs.dtype])
    grouped_matmul_dw.launches += 1
    return out


grouped_matmul_dx.launches = 0
grouped_matmul_dw.launches = 0


class _GroupedMatmul(torch.autograd.Function):
    """The grouped product with megablox's custom VJP (``ops.py``
    ``_gmm_bwd``): dx by ``grouped_matmul_dx``, dW by ``grouped_matmul_dw``.
    The incoming gradient holds the output dtype's values, as the JAX
    cotangent of ``gmm(...).astype(dtype)`` does widened to fp32, so the
    bf16 kernels' exact products reproduce megablox's fp32 products up to
    summation order."""

    @staticmethod
    def forward(ctx, xs, w, group_offsets):
        ctx.save_for_backward(xs, w, group_offsets)
        return _grouped_matmul_forward(xs, w, group_offsets)

    @staticmethod
    def backward(ctx, dy):
        xs, w, group_offsets = ctx.saved_tensors
        dy = dy.to(xs.dtype).contiguous()
        dx = grouped_matmul_dx(dy, w, group_offsets) \
            if ctx.needs_input_grad[0] else None
        dw = grouped_matmul_dw(xs, dy, group_offsets) \
            if ctx.needs_input_grad[1] else None
        return dx, dw, None


def grouped_matmul(xs, w, group_offsets):
    """``out[r] = xs[r] @ w[e(r)]`` for rows sorted by expert, fp32
    accumulation rounded once to xs's dtype. See the module docstring.

    CUDA tensors launch the sm_90a kernel (``grouped_matmul.launches``
    counts each launch); CPU tensors run ``grouped_matmul_reference``.
    Differentiable: when autograd records it, the backward runs
    ``grouped_matmul_dx`` and ``grouped_matmul_dw``, and an fp16 product
    raises megablox's ``ValueError``."""
    if torch.is_grad_enabled() and (xs.requires_grad or w.requires_grad):
        _check_backward_dtype(xs.dtype)
        return _GroupedMatmul.apply(xs, w, group_offsets)
    return _grouped_matmul_forward(xs, w, group_offsets)


grouped_matmul.launches = 0


def moe_scatter(top_idx, n_experts):
    """Stable sort of the T*k (token, slot) rows by expert, on the device.
    Returns (order [T*k]: the flat (token, slot) index of each sorted row,
    group_offsets int32 [E+1]). The offsets come from a search of the sorted
    expert ids (``bincount`` would read the largest id on the host)."""
    sorted_e, order = torch.sort(top_idx.reshape(-1), stable=True)
    bounds = torch.arange(n_experts + 1, dtype=sorted_e.dtype,
                          device=sorted_e.device)
    return order, torch.searchsorted(sorted_e, bounds, out_int32=True)


def moe_ffn_gmm_rows(x_rows, row_experts, w1, w2, w3, *, n_experts, dtype,
                     matmul=grouped_matmul):
    """Per-row expert FFN (the JAX ``moe_ffn_gmm_rows``, kernel row 9b): row
    ``i`` goes through expert ``row_experts[i]`` as ``silu(x@w1) * (x@w3) @
    w2``, outputs in input row order, with no gate weighting and no k-slot
    sum (the expert-parallel shard runs it on the rows it received and the
    senders weight them). x_rows [R, D]; row_experts int [R]; w1/w3 [E, D,
    F]; w2 [E, F, D] with E = ``n_experts`` -> [R, D] in ``dtype``.

    Rows are sorted stably by expert and each product accumulates in fp32
    and is cast to ``dtype``, the JAX rounding points. A row whose id is
    ``n_experts`` or more is a sentinel (the zero padding of the expert-
    parallel receive buffer): it sorts past the last group's offset, the
    products skip it on the device without a host sync, and its output and
    input gradient are 0, what the JAX shard gets from running zero rows
    through the last expert. On CUDA tensors with the default ``matmul``
    it launches the grouped kernels and counts one in
    ``moe_ffn_gmm_rows.launches``."""
    order, offsets = moe_scatter(row_experts.reshape(-1, 1), n_experts)
    real = (row_experts < n_experts)[:, None]
    real_sorted = real[order]
    xs = torch.where(real_sorted, x_rows[order].to(dtype), 0)
    h = F.silu(matmul(xs, w1, offsets)) * matmul(xs, w3, offsets)
    y = matmul(h, w2, offsets)                                # [R, D] sorted
    out = torch.empty_like(y)
    out[order] = torch.where(real_sorted, y, 0)
    if matmul is grouped_matmul and x_rows.device.type == "cuda":
        moe_ffn_gmm_rows.launches += 1
    return out


moe_ffn_gmm_rows.launches = 0


def moe_ffn_gmm(x, top_vals, top_idx, w1, w2, w3, *, n_experts, dtype,
                matmul=grouped_matmul):
    """Mixtral expert FFN ``silu(x@w1) * (x@w3) @ w2`` per expert, routed by
    ``topk_router``'s (top_vals, top_idx): moe_scatter, three grouped
    products (``matmul``: the kernel by default, or its plain version), and
    moe_gather (unsort, gate weighting and the k-slot sum in fp32, cast
    once). x [T, D] -> [T, D] in ``dtype``."""
    T, D = x.shape
    k = top_idx.shape[-1]
    order, offsets = moe_scatter(top_idx, n_experts)
    xs = x[order // k].to(dtype)                              # [T*k, D]
    h = F.silu(matmul(xs, w1, offsets)) * matmul(xs, w3, offsets)
    y = matmul(h, w2, offsets)                                # [T*k, D]
    unsorted = torch.empty_like(y)
    unsorted[order] = y
    return (unsorted.view(T, k, D).float()
            * top_vals[..., None]).sum(1).to(dtype)
